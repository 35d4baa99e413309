"""The plain reference the benchmark holds the port against: a decoder in
float32 PyTorch, TF32 off, with no kernel, cache or batching of the port
(``model.py``), its three training steps under Adam (``train.py``) and
its teacher-forced logits over served requests (``serve.py``).  It
imports nothing of ``k8s_tpu_torch``; it makes its weights again from
the seed, layer by layer, as the benchmark made them for the port.
"""
