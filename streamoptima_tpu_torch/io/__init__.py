from streamoptima_tpu_torch.io.video import VideoManager

__all__ = ["VideoManager"]
