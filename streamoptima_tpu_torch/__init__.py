"""StreamOptima on PyTorch + CUDA (NVIDIA Hopper).

A port of the ``streamoptima_tpu`` codec (a simplified H.264-style, luma-only
block codec) that runs everything the JAX package runs, both engines
included: the native one (``TorchCodec``) and the one bit-exact with the
NumPy reference (``engine="compat"``: ``compat_engine.CompatCodec``, its
scipy-exact float64 DCT and every reference quirk):

- I/P frames with intra modes 0 and 1; full-search or fast motion
  estimation, whole-pel or half-pel (FME), with or without variable block
  size (VBS), over up to eight reference frames; the reference's three
  parallel modes;
- the exact fixed-point integer DCT, power-of-two quantization, RLE;
- rate control: per-row QPs, ROI QP maps, scene-change promotion, two-pass;
- the text bitstream and the one-file binary container, byte-identical to
  the JAX package's;
- GOP- and row-tile-sharded encode and decode over a mesh of devices
  (``parallel``), with its dry run;
- the ``VideoCodec`` facade with PSNR and SSIM on the device, the command
  line (``python -m streamoptima_tpu_torch``), the colour pipeline
  (``io.video``), ``profiling`` and ``viz``.

Plain code is PyTorch.  The kernels are hand-written CUDA C++ for
``sm_90a``, twelve sources under ``csrc/`` built with ``nvcc`` at first use
(``_build.py``): the whole-pel and half-pel searches (``full_search``,
``full_search_fme``), the prediction fetch (``pred_fetch``), fast ME's chain
pass, region gather and confirm (``rowscan_pass``, ``window_fetch``,
``fast_confirm``), the intra search and reconstruction (``intra_search``,
``intra_recon``), the residual coding (``transform_select``,
``residual_recon``), the binary container's RLE (``rle_pack``) and the
compat engine's scipy-exact DCT (``dct_scipy``).  ``core/motion.py`` alone
chooses and launches the search, fetch and fast-ME kernels of a tool set.  Tensors on the CPU take each kernel's plain
PyTorch version instead, which is what the CPU tests hold against the JAX
package.  Entry points run on the card unless the caller names the CPU.

The package stands alone: it imports neither JAX nor the JAX package, and
keeps its own copies of the JAX-free pieces it needs (``config``,
``bitstream``, ``binstream``, the ``native`` host serializer, ``io.video``,
``utils.clips``, ``metrics``, ``rc``, ``viz`` and the constant tables under
``core``).  matplotlib is needed only by ``viz``'s figures.
"""
from streamoptima_tpu_torch.config import CodecConfig, parse_bitrate
from streamoptima_tpu_torch.utils import synthetic_clip
from streamoptima_tpu_torch.codec import VideoCodec
from streamoptima_tpu_torch.engine import TorchCodec

__all__ = ["CodecConfig", "TorchCodec", "VideoCodec", "parse_bitrate", "synthetic_clip"]
