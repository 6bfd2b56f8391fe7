from streamoptima_tpu_torch.utils.clips import synthetic_clip  # noqa: F401
