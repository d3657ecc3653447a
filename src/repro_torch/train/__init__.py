from repro_torch.train.steps import make_prefill, make_serve_step  # noqa: F401
