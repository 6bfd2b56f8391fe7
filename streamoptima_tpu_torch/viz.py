"""Visualization: MV fields, VBS partition overlays, quality plots, grids.

The port's copy of ``streamoptima_tpu.viz`` (numpy, and matplotlib for the
figures).  matplotlib is imported inside the figure functions only, so that
importing this module, ``mv_field`` and ``vbs_overlay_frames`` (the command
line's ``--vbs-overlay``) need numpy alone.

Twin of the reference's matplotlib helpers (visualize_motion_vectors
Encoder.py:363-380, visualize_reference_frames :331-361, plot_psnr_ssim
:962-979, visualize_comparison :317-329, construct_VBS_overlay
decoder.py:85-94).  All figure functions return the matplotlib Figure and
only write to disk when ``save`` is given, so they are headless-safe
(MPLBACKEND=Agg).
"""
from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def mv_field(mvs_frame, cfg):
    """(nbr, nbc, 3) [dx, dy, ref] from one frame's MV interchange list
    (inter frames; splits contribute their first sub-MV, matching the
    reference's per-block arrow plot)."""
    nbr, nbc = cfg.block_rows, cfg.blocks_per_row
    out = np.zeros((nbr, nbc, 3), dtype=np.int32)
    for i, (split, mv) in enumerate(mvs_frame):
        r, c = divmod(i, nbc)
        v = mv[0] if split else mv
        out[r, c] = np.asarray(v if np.ndim(v) else (v, 0, 0))
    return out


def visualize_motion_vectors(frame, mvs_frame, cfg, save=None):
    """Quiver plot of per-block MVs over the frame (Encoder.py:363-380)."""
    plt = _plt()
    f = mv_field(mvs_frame, cfg)
    bs = cfg.block_size
    ys, xs = np.mgrid[0 : cfg.height : bs, 0 : cfg.width : bs]
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.imshow(np.asarray(frame), cmap="gray")
    ax.quiver(xs + bs // 2, ys + bs // 2, f[..., 0], f[..., 1], color="red",
              angles="xy", scale_units="xy", scale=1)
    ax.set_title("motion vectors")
    if save:
        fig.savefig(save, dpi=120, bbox_inches="tight")
    return fig


def visualize_reference_frames(frame, mvs_frame, cfg, save=None):
    """Per-block chosen reference index as a colormapped grid
    (Encoder.py:331-361)."""
    plt = _plt()
    f = mv_field(mvs_frame, cfg)
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.imshow(np.asarray(frame), cmap="gray")
    im = ax.imshow(
        np.kron(f[..., 2], np.ones((cfg.block_size, cfg.block_size))),
        cmap="viridis", alpha=0.45, vmin=0, vmax=max(1, cfg.n_ref_frames - 1),
    )
    fig.colorbar(im, ax=ax, label="reference frame index")
    ax.set_title("reference frame usage")
    if save:
        fig.savefig(save, dpi=120, bbox_inches="tight")
    return fig


def plot_psnr_ssim(psnr_per_frame, ssim_per_frame=None, save=None):
    """Per-frame PSNR (and SSIM) curves (Encoder.py:962-979)."""
    plt = _plt()
    fig, ax1 = plt.subplots(figsize=(8, 4))
    ax1.plot(psnr_per_frame, "o-", label="PSNR (dB)")
    ax1.set_xlabel("frame")
    ax1.set_ylabel("PSNR (dB)")
    if ssim_per_frame is not None:
        ax2 = ax1.twinx()
        ax2.plot(ssim_per_frame, "s--", color="tab:orange", label="SSIM")
        ax2.set_ylabel("SSIM")
    fig.legend(loc="lower right")
    ax1.set_title("reconstruction quality per frame")
    if save:
        fig.savefig(save, dpi=120, bbox_inches="tight")
    return fig


def visualize_comparison(original, reconstructed, decoded=None, save=None):
    """Side-by-side original / reconstructed / decoded (Encoder.py:317-329)."""
    plt = _plt()
    imgs = [("original", original), ("reconstructed", reconstructed)]
    if decoded is not None:
        imgs.append(("decoded", decoded))
    fig, axes = plt.subplots(1, len(imgs), figsize=(5 * len(imgs), 4))
    for ax, (title, img) in zip(np.atleast_1d(axes), imgs):
        ax.imshow(np.asarray(img), cmap="gray", vmin=0, vmax=255)
        ax.set_title(title)
        ax.axis("off")
    if save:
        fig.savefig(save, dpi=120, bbox_inches="tight")
    return fig


def view_frame(frame, title: str = "frame", save=None):
    """Single-plane viewer (view_frame, video_manager.py:99-142)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.imshow(np.asarray(frame), cmap="gray", vmin=0, vmax=255)
    ax.set_title(title)
    ax.axis("off")
    if save:
        fig.savefig(save, dpi=120, bbox_inches="tight")
    return fig


def view_frame_yuv(yuv444_frame, save=None):
    """Y/U/V plane triptych (view_frame_diff_planes twin)."""
    plt = _plt()
    fig, axes = plt.subplots(1, 3, figsize=(14, 4))
    for ax, name, plane in zip(axes, "YUV", np.asarray(yuv444_frame)):
        ax.imshow(plane, cmap="gray", vmin=0, vmax=255)
        ax.set_title(name)
        ax.axis("off")
    if save:
        fig.savefig(save, dpi=120, bbox_inches="tight")
    return fig


def view_frame_rgb(rgb_frame, save=None):
    """RGB frame viewer (view_frame_rgb twin)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.imshow(np.asarray(rgb_frame))
    ax.axis("off")
    if save:
        fig.savefig(save, dpi=120, bbox_inches="tight")
    return fig


def vbs_overlay_frames(frames, mvs_per_frame, frame_types, cfg):
    """Zero out each block's top/left edge — plus the mid cross when split —
    making the partition grid visible (construct_VBS_overlay twin,
    decoder.py:85-94).  Returns a new (n, h, w) uint8 clip."""
    bs = cfg.block_size
    s = bs // 2
    nbc = cfg.blocks_per_row
    out = np.asarray(frames).copy()
    for fi, mvs in enumerate(mvs_per_frame):
        f = out[fi]
        for i, (split, _mv) in enumerate(mvs):
            r, c = divmod(i, nbc)
            y, x = r * bs, c * bs
            f[y, x : x + bs] = 0
            f[y : y + bs, x] = 0
            if split:
                f[y + s, x : x + bs] = 0
                f[y : y + bs, x + s] = 0
    return out
