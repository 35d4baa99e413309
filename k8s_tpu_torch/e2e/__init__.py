"""In-pod payloads of the operator's gang end-to-end runs, on the port:
``python -m k8s_tpu_torch.e2e.rendezvous_worker`` under
``k8s_tpu.e2e.multiprocess.run_gang(n, module=...)``."""
