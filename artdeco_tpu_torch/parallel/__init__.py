from artdeco_tpu_torch.parallel import dp  # noqa: F401
