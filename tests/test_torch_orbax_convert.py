"""``tools/orbax_to_torch.py``: a JAX package serving export (orbax params
+ ``model_config.json``) converted into the port's artifact, on the CPU.

The port loads the converted directory as one of its own exports: its
logits equal the JAX model's (f32, 1e-5 relative to the largest logit:
summation order only), and the port's server answers a greedy request
with the JAX server's tokens over the same export.  Before conversion the
port refuses the directory and names the converter.
"""

import json
import os
import subprocess
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_tpu.models import serving as jax_serving
from k8s_tpu.models.server import LmServer as JaxLmServer
from k8s_tpu.models.server import serve as jax_serve
from k8s_tpu.models.transformer import Transformer as JaxTransformer
from k8s_tpu.models.transformer import TransformerConfig as JaxConfig
from k8s_tpu.util.metrics import Registry as JaxRegistry
from k8s_tpu_torch.models import bridge, serving
from k8s_tpu_torch.models.server import LmServer, serve
from k8s_tpu_torch.models.transformer import Transformer
import torch_world

_one_torch_thread = pytest.fixture(autouse=True)(
    torch_world.one_torch_thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "orbax_to_torch.py")
SHAPE = dict(vocab_size=256, hidden=32, ffn_hidden=64, layers=2, heads=4,
             kv_heads=2, max_seq_len=64, remat=False)


def _convert(train_dir):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, TOOL, "--train_dir", train_dir],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=240)


@pytest.fixture(scope="module")
def export(tmp_path_factory):
    """(train_dir of a JAX export, its config, its params), unconverted."""
    cfg = JaxConfig(dtype=jnp.float32, **SHAPE)
    params = jax.device_get(JaxTransformer(cfg).init(
        jax.random.PRNGKey(7), jnp.zeros((1, 5), jnp.int32))["params"])
    d = str(tmp_path_factory.mktemp("jax_export"))
    jax_serving.export_serving(d, cfg, {"params": params})
    return d, cfg, params


@pytest.fixture(scope="module")
def converted(export):
    d, cfg, params = export
    with pytest.raises(FileNotFoundError, match="tools/orbax_to_torch.py"):
        serving.load_serving(d, device="cpu")
    with open(os.path.join(d, "serving", serving.CONFIG_FILE)) as f:
        config_bytes = f.read()
    r = _convert(d)
    assert r.returncode == 0, r.stderr
    assert "params.pt" in r.stdout
    with open(os.path.join(d, "serving", serving.CONFIG_FILE)) as f:
        assert f.read() == config_bytes  # the config is left as it was
    return export


def test_converted_params_and_logits_equal_the_jax_model(converted):
    d, cfg, params = converted
    config, sd = serving.load_serving(d, device="cpu")
    assert config.dtype == torch.float32 and config.layers == cfg.layers
    want_sd = bridge.params_from_jax(params)
    assert set(sd) == set(want_sd)
    for name, t in want_sd.items():
        assert torch.equal(sd[name], t), name
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    want = np.asarray(JaxTransformer(cfg).apply({"params": params},
                                                jnp.asarray(tokens)))
    with torch.no_grad():
        got = Transformer(config, sd, device="cpu")(
            torch.from_numpy(tokens).long()).numpy()
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


def _post(url, payload):
    req = urllib.request.Request(
        url + "/v1/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def test_port_server_answers_like_the_jax_server(converted):
    d = converted[0]
    jcfg, jvars = jax_serving.load_serving(d)
    tcfg, tparams = serving.load_serving(d, device="cpu")
    jlm = JaxLmServer(config=jcfg, params=jvars["params"], slots=0,
                      registry=JaxRegistry())
    tlm = LmServer(config=tcfg, params=tparams, slots=0, device="cpu")
    jh, th = jax_serve(jlm), serve(tlm)
    try:
        payload = {"tokens": [3, 1, 4, 1, 5, 9], "max_new_tokens": 8}
        want = _post("http://%s:%d" % jh.server_address[:2], payload)
        got = _post("http://%s:%d" % th.server_address[:2], payload)
        assert got["tokens"] == want["tokens"] and len(want["tokens"]) == 8
    finally:
        for h, lm in ((jh, jlm), (th, tlm)):
            h.shutdown()
            lm.close()
