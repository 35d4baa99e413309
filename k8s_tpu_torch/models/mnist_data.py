"""MNIST-format (IDX) dataset files: port of ``k8s_tpu/models/mnist_data.py``,
the port's own copy (the reference module uses only the stdlib and numpy,
and the port imports nothing of ``k8s_tpu``).

An IDX3 image file is the magic 0x803, then big-endian ``n, rows, cols``
and ``n*rows*cols`` raw uint8 pixels; an IDX1 label file the magic 0x801,
``n`` and ``n`` uint8 labels; either may be gzipped.  ``load_dataset``
reads the training split of an MNIST-layout directory (``--data_dir`` of
``k8s_tpu_torch.dist_mnist``).  The writers produce gzip bytes with
mtime 0, so a fixture rebuilt from the same data is byte for byte the
same.

The repository's ``tests/fixtures/mnist`` is such a fixture (1797 real
scanned digits from the UCI set, upscaled to 28x28; ``SHA256SUMS`` beside
it), built by ``build_digits_fixture``, which needs sklearn and is never
run where that is missing: the committed files are read instead.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

IMAGES_MAGIC = 0x00000803
LABELS_MAGIC = 0x00000801

TRAIN_IMAGES = "train-images-idx3-ubyte.gz"
TRAIN_LABELS = "train-labels-idx1-ubyte.gz"


def _open(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def _read_header(f, fmt: str, path: str) -> tuple:
    size = struct.calcsize(fmt)
    head = f.read(size)
    if len(head) != size:
        raise ValueError(f"{path}: truncated header ({len(head)} bytes)")
    return struct.unpack(fmt, head)


def read_idx_images(path: str) -> np.ndarray:
    """Parse an IDX3 image file -> [N, rows, cols] uint8."""
    with _open(path) as f:
        magic, n, rows, cols = _read_header(f, ">IIII", path)
        if magic != IMAGES_MAGIC:
            raise ValueError(
                f"{path}: bad magic {magic:#x}, want {IMAGES_MAGIC:#x} "
                f"(IDX3 images)")
        buf = f.read(n * rows * cols)
    if len(buf) != n * rows * cols:
        raise ValueError(f"{path}: truncated — {len(buf)} bytes for "
                         f"{n}x{rows}x{cols}")
    return np.frombuffer(buf, dtype=np.uint8).reshape(n, rows, cols)


def read_idx_labels(path: str) -> np.ndarray:
    """Parse an IDX1 label file -> [N] uint8."""
    with _open(path) as f:
        magic, n = _read_header(f, ">II", path)
        if magic != LABELS_MAGIC:
            raise ValueError(
                f"{path}: bad magic {magic:#x}, want {LABELS_MAGIC:#x} "
                f"(IDX1 labels)")
        buf = f.read(n)
    if len(buf) != n:
        raise ValueError(f"{path}: truncated — {len(buf)} bytes for {n}")
    return np.frombuffer(buf, dtype=np.uint8)


def write_idx_images(path: str, images: np.ndarray) -> None:
    images = np.asarray(images, dtype=np.uint8)
    n, rows, cols = images.shape
    payload = struct.pack(">IIII", IMAGES_MAGIC, n, rows, cols) + \
        images.tobytes()
    # mtime=0 keeps the gzip bytes reproducible across fixture rebuilds
    with gzip.GzipFile(path, "wb", mtime=0) as f:
        f.write(payload)


def write_idx_labels(path: str, labels: np.ndarray) -> None:
    labels = np.asarray(labels, dtype=np.uint8)
    payload = struct.pack(">II", LABELS_MAGIC, len(labels)) + labels.tobytes()
    with gzip.GzipFile(path, "wb", mtime=0) as f:
        f.write(payload)


def load_dataset(data_dir: str) -> tuple[np.ndarray, np.ndarray]:
    """Load the training split from an MNIST-layout directory.

    Returns (x [N, 28, 28, 1] float32 in [0, 1], y [N] int32) — the shapes
    models.mnist.MnistCNN and cross_entropy_loss consume.
    """
    images = read_idx_images(os.path.join(data_dir, TRAIN_IMAGES))
    labels = read_idx_labels(os.path.join(data_dir, TRAIN_LABELS))
    if len(images) != len(labels):
        raise ValueError(
            f"{data_dir}: {len(images)} images vs {len(labels)} labels")
    x = (images.astype(np.float32) / 255.0)[..., None]
    return x, labels.astype(np.int32)


def build_digits_fixture(out_dir: str) -> tuple[np.ndarray, np.ndarray]:
    """Write the packaged real-digits fixture: UCI handwritten digits
    (8x8 grayscale scans) nearest-upscaled to 28x28 and emitted as genuine
    IDX+gzip MNIST-layout files.  Deterministic bytes (gzip mtime=0)."""
    from sklearn.datasets import load_digits

    X, y = load_digits(return_X_y=True)
    imgs8 = (X.reshape(-1, 8, 8) / 16.0 * 255.0).astype(np.uint8)
    # nearest-neighbour 8->24 (x3), then pad 2 px each side to 28
    imgs24 = np.repeat(np.repeat(imgs8, 3, axis=1), 3, axis=2)
    imgs28 = np.pad(imgs24, ((0, 0), (2, 2), (2, 2)))
    os.makedirs(out_dir, exist_ok=True)
    write_idx_images(os.path.join(out_dir, TRAIN_IMAGES), imgs28)
    write_idx_labels(os.path.join(out_dir, TRAIN_LABELS), y)
    return imgs28, y.astype(np.int32)
