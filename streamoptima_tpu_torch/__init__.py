"""StreamOptima on PyTorch + CUDA (NVIDIA Hopper).

A port of the ``streamoptima_tpu`` codec: I/P frames with full-search motion
estimation, whole-pel or with variable block size (VBS) and half-pel
fractional ME (FME), mode-0 intra prediction, the exact fixed-point integer
DCT, power-of-two quantization and the text bitstream.  Plain code is
PyTorch; the kernels of the path (the whole-pel search, the FME + VBS
search and the prediction fetch) are hand-written CUDA C++ for ``sm_90a``
under ``csrc/``, built with ``nvcc`` at first use (``_build.py``).  Tensors
on the CPU take each kernel's plain PyTorch version instead, which is what
the CPU tests hold against the JAX package.

The package stands alone: it imports neither JAX nor the JAX package, and
keeps its own copies of the JAX-free pieces it needs (``config``,
``bitstream``, the ``native`` host serializer, ``io.video``,
``utils.clips``, ``metrics`` and the constant tables under ``core``).
"""
from streamoptima_tpu_torch.config import CodecConfig
from streamoptima_tpu_torch.utils import synthetic_clip
from streamoptima_tpu_torch.codec import VideoCodec
from streamoptima_tpu_torch.engine import TorchCodec

__all__ = ["CodecConfig", "TorchCodec", "VideoCodec", "synthetic_clip"]
