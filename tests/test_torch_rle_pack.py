"""PyTorch port, the container's run-length coding on the device
(``K.rle_pack``, ``csrc/rle_pack.cu``) and the container write that uses it.

Kernel level, on the CPU: the plain version's symbols equal the C++
runtime's ``native.rle_encode_blocks`` and ``zigzag.rle_encode_block``
symbol for symbol (zero, all-nonzero, alternating, trailing-run, +-4080 and
random blocks; bs 8 and 16; no, some and every block split); its unit
lengths equal ``rle_length`` of the variant each block uses and a frame's
total ``transform_select``'s size; a numpy transcription of the kernel's
rule (ballot masks, popc slots, the chunked offsets of its write launch)
gives the same buffer; MVs are widened, zeroed and range-checked as the
host route does; the wrapper refuses what it does not take.

Container level: a ``package=False`` encode written through the coded route
(the plain version on the CPU) is byte-identical to the same encode written
through the host route (``package=True``, ``native``) and to the JAX
package's file, over whole-pel, VBS, FME, fast ME + VBS + FME, rate
control, an ROI map, intra mode 1 and a CPU mesh; ``rle_frames`` names the
route; a coded total that disagrees with the package's residual size
raises.  The kernel itself runs in ``tests/test_torch_gpu.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import synthetic_clip

from streamoptima_tpu import CodecConfig as JaxCodecConfig
from streamoptima_tpu.codec import VideoCodec as JaxVideoCodec
from streamoptima_tpu_torch import CodecConfig, binstream, native
from streamoptima_tpu_torch.codec import VideoCodec
from streamoptima_tpu_torch.core import kernels as K
from streamoptima_tpu_torch.core import zigzag as Z
from streamoptima_tpu_torch.core.zigzag import diag_scan_indices
from streamoptima_tpu_torch.parallel import make_mesh
from streamoptima_tpu_torch.profiling import tracer

torch.set_num_threads(1)
RC_TABLES = [
    [9000, 4000, 2000, 1100, 800, 600, 450, 350, 280, 230, 200, 180],
    [8000, 3500, 1800, 1000, 700, 500, 400, 300, 250, 210, 190, 170],
]
RC = {"rc_flag": 1, "target_br": "300 kbps", "frame_rate": 30, "qp_rate_tables": RC_TABLES}
ROI = np.zeros((4, 6), np.int32)
ROI[1:3, 2:4] = -2


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracer.disable()
    tracer.reset()
    yield
    tracer.disable()
    tracer.reset()


# ------------------------------------------------------------ kernel level
def _blocks(kind: str, shape, rng) -> np.ndarray:
    """Coefficient blocks (..., n, n) of one kind."""
    n = shape[-1]
    if kind == "zero":
        return np.zeros(shape, np.int64)
    if kind == "nonzero":
        return rng.choice([-1, 1], shape) * rng.integers(1, 4081, shape)
    if kind == "alternating":  # every scan position alternates zero / nonzero
        alt = np.zeros(n * n, np.int64)
        alt[diag_scan_indices(n)[::2]] = 7
        return np.broadcast_to(alt.reshape(n, n), shape).copy()
    if kind == "trailing":  # a nonzero head, then zeros to the end
        b = np.zeros(shape, np.int64)
        flat = b.reshape(-1, n * n)
        flat[:, diag_scan_indices(n)[:3]] = [-4080, 4080, 1]
        return b
    if kind == "extremes":
        return rng.choice([-4080, 0, 4080], shape)
    return np.where(rng.random(shape) < rng.random(), rng.integers(-4080, 4081, shape), 0)


def _frames(rng, n: int, nb: int, kinds, splits) -> dict:
    """One segment's per-frame tensors: frame i of kind ``kinds[i]`` and split
    pattern ``splits[i]`` ("none", "all" or "some"); frame 0 intra (scalar
    MVs), the rest inter."""
    s = n // 2
    out = {k: [] for k in ("split", "mv", "sub_mv", "qtc_full", "qtc_quads")}
    for i, (kind, sp) in enumerate(zip(kinds, splits)):
        split = {"none": np.zeros(nb, bool), "all": np.ones(nb, bool), "some": rng.random(nb) < 0.5}[sp]
        tail = () if i == 0 else (3,)
        out["split"].append(torch.from_numpy(split))
        out["mv"].append(torch.from_numpy(rng.integers(-40, 41, (nb,) + tail).astype(np.int32)))
        out["sub_mv"].append(torch.from_numpy(rng.integers(-40, 41, (nb, 4) + tail).astype(np.int32)))
        out["qtc_full"].append(torch.from_numpy(_blocks(kind, (nb, n, n), rng).astype(np.int16)))
        out["qtc_quads"].append(torch.from_numpy(_blocks(kind, (nb, 4, s, s), rng).astype(np.int16)))
    return out


def _reference(fr: dict, f: int, n: int):
    """Frame f's container lists by the host runtime: (vals_f, offs_f, vals_q, offs_q)."""
    split = fr["split"][f].numpy()
    vf, of = native.rle_encode_blocks(fr["qtc_full"][f].numpy()[~split])
    vq, oq = native.rle_encode_blocks(fr["qtc_quads"][f].numpy()[split].reshape(-1, n // 2, n // 2))
    return vf, of, vq, oq


def _pack(fr: dict, cap: int) -> np.ndarray:
    return K.rle_pack(fr["split"], fr["mv"], fr["sub_mv"], fr["qtc_full"], fr["qtc_quads"], cap).numpy()


@pytest.mark.parametrize("splits", [("none", "none", "none"), ("all", "all", "all"), ("some", "none", "all")],
                         ids=["no_split", "all_split", "mixed"])
@pytest.mark.parametrize("kind", ["zero", "nonzero", "alternating", "trailing", "extremes", "random"])
@pytest.mark.parametrize("n", [8, 16])
def test_plain_version_equals_the_host_runtime(n, kind, splits):
    """Symbol for symbol the lists of ``native.rle_encode_blocks`` and
    ``zigzag.rle_encode_block``; unit lengths ``rle_length`` of the chosen
    variant; the header's split flags and MVs as the host route writes them."""
    rng = np.random.default_rng(n * 7 + len(kind))
    nb = 23
    fr = _frames(rng, n, nb, [kind, "random" if kind == "zero" else kind, kind], splits)
    refs = [_reference(fr, f, n) for f in range(3)]
    sizes = [len(vf) + len(vq) for vf, _, vq, _ in refs]
    buf = _pack(fr, sum(sizes))
    a, s0 = K.rle_pack_layout(3, nb)
    totals = buf[:12].view(np.int32).reshape(3, 2)
    assert totals.sum(1).tolist() == sizes and buf[12:a].view(np.int32).tolist() == [0, 0]
    pos = s0
    for f, (vf, of, vq, oq) in enumerate(refs):
        head = buf[a + f * K.RLE_HDR * nb: a + (f + 1) * K.RLE_HDR * nb]
        split = fr["split"][f].numpy()
        np.testing.assert_array_equal(head[:nb], split)
        lens = head[16 * nb:].reshape(nb, 4)
        np.testing.assert_array_equal(lens[~split, 0], Z.rle_length(fr["qtc_full"][f]).numpy()[~split])
        np.testing.assert_array_equal(lens[split], Z.rle_length(fr["qtc_quads"][f]).numpy()[split])
        assert not lens[~split, 1:].any()
        np.testing.assert_array_equal(np.cumsum(lens[~split, 0]), of[1:])
        np.testing.assert_array_equal(np.cumsum(lens[split].reshape(-1)), oq[1:])
        got = buf[pos: pos + len(vf) + len(vq)]
        np.testing.assert_array_equal(got, np.concatenate([vf, vq]))
        qf = fr["qtc_full"][f].numpy()
        assert [int(v) for v in got[: len(vf)]] == [int(x) for b in qf[~split] for x in Z.rle_encode_block(b)]
        pos += len(vf) + len(vq)
        m3 = head[nb: 4 * nb].reshape(nb, 3)
        mv = fr["mv"][f].numpy().reshape(nb, -1)
        np.testing.assert_array_equal(m3[:, : mv.shape[1]], np.where(split[:, None], 0, mv))
        assert not m3[:, mv.shape[1]:].any()
        s3 = head[4 * nb: 16 * nb].reshape(nb, 4, 3)
        smv = fr["sub_mv"][f].numpy().reshape(nb, 4, -1)
        np.testing.assert_array_equal(s3[:, :, : smv.shape[2]], np.where(split[:, None, None], smv, 0))


def test_frame_totals_equal_transform_select_sizes():
    """A frame step's coded size (``transform_select``'s lens, summed) is the
    frame's total in the buffer."""
    rng = np.random.default_rng(11)
    nb, n, s = 40, 16, 8
    res = torch.from_numpy(rng.integers(-255, 256, (nb, n, n)) * (rng.random((nb, 1, 1)) < 0.7)).to(torch.int32)
    quads = res.reshape(nb, 2, s, 2, s).swapaxes(2, 3).reshape(nb, 4, s, s).contiguous()
    sad = torch.from_numpy(rng.integers(0, 255 * n * n, nb).astype(np.int32))
    sub_sad = torch.from_numpy(rng.integers(0, 255 * s * s, (nb, 4)).astype(np.int32))
    split, qf, qq, lens, _ = K.transform_select(res, quads, sad, sub_sad, 1, torch.full((nb,), 2, dtype=torch.int32),
                                                qp_nominal=4, lam=0.015, vbs_enable=True,
                                                vbs_eligible=torch.ones(nb, dtype=torch.bool), bs=n, sbs=s)
    assert split.any() and not split.all()
    mv = torch.zeros((nb, 3), dtype=torch.int32)
    buf = K.rle_pack([split], [mv], [torch.zeros((nb, 4, 3), dtype=torch.int32)], [qf.to(torch.int16)],
                     [qq.to(torch.int16)], int(lens.sum())).numpy()
    assert int(buf[:4].view(np.int32).sum()) == int(lens.sum())
    a, _ = K.rle_pack_layout(1, nb)
    got = buf[a + 16 * nb: a + 20 * nb].reshape(nb, 4).sum(1)
    np.testing.assert_array_equal(got, lens.numpy())


def _warp_unit(vals: np.ndarray) -> tuple[list, int]:
    """A transcription of ``code_unit`` in csrc/rle_pack.cu: a unit's m
    values in scan order -> (its symbols, its length), from 32-bit ballot
    words, popc slots and the next start's position."""
    m = len(vals)
    words = -(-m // 32)
    v = np.zeros(32 * words, np.int64)
    v[:m] = vals
    nz = [sum(1 << ln for ln in range(32) if v[32 * k + ln] != 0) for k in range(words)]
    st = []
    for k in range(words):
        left = m - 32 * k
        valid = 0xFFFFFFFF if left >= 32 else (1 << left) - 1
        prev = ((nz[k] << 1) & 0xFFFFFFFF) | (nz[k - 1] >> 31 if k else 0)
        st.append(((nz[k] ^ prev) | (1 if k == 0 else 0)) & valid)
    total = sum(bin(x).count("1") for x in nz + st)
    out = [None] * total
    nz_below = st_below = 0
    for k in range(words):
        for ln in range(32):
            u = 32 * k + ln
            lt, le = (1 << ln) - 1, (1 << (ln + 1)) - 1
            slot = nz_below + bin(nz[k] & lt).count("1") + st_below + bin(st[k] & le).count("1")
            if nz[k] >> ln & 1:
                out[slot] = int(v[u])
            if st[k] >> ln & 1:
                above = st[k] & ~le & 0xFFFFFFFF
                nxt = m
                if above:
                    nxt = 32 * k + (above & -above).bit_length() - 1
                else:
                    for j in range(words - 1, k, -1):
                        if st[j]:
                            nxt = 32 * j + (st[j] & -st[j]).bit_length() - 1
                length = nxt - u
                out[slot - 1] = -length if nz[k] >> ln & 1 else (0 if nxt == m else length)
        nz_below += bin(nz[k]).count("1")
        st_below += bin(st[k]).count("1")
    return out, total


def _kernel_transcription(fr: dict, n: int, cap: int) -> np.ndarray:
    """The symbols region as the kernel's two launches place it: launch 1's
    per-frame totals and unit lengths, then per CTA of 64 blocks the frame
    base, the prefix of the blocks before the chunk and the chunk's scan."""
    frames, nb, s = len(fr["split"]), fr["split"][0].shape[0], n // 2
    sf, sq = diag_scan_indices(n), diag_scan_indices(s)
    lens, tf, tq, split = [], [], [], []
    for f in range(frames):
        sp = fr["split"][f].numpy()
        qf = fr["qtc_full"][f].numpy().reshape(nb, -1)
        qq = fr["qtc_quads"][f].numpy().reshape(nb, 4, -1)
        ln = np.zeros((nb, 4), np.int64)
        for b in range(nb):
            if sp[b]:
                ln[b] = [_warp_unit(qq[b, q][sq])[1] for q in range(4)]
            else:
                ln[b, 0] = _warp_unit(qf[b][sf])[1]
        lens.append(ln)
        split.append(sp)
        tf.append(int(ln[~sp, 0].sum()))
        tq.append(int(ln[sp].sum()))
    out = np.full(cap, -9999, np.int64)
    for f in range(frames):
        sp, ln = split[f], lens[f]
        qf = fr["qtc_full"][f].numpy().reshape(nb, -1)
        qq = fr["qtc_quads"][f].numpy().reshape(nb, 4, -1)
        base = sum(tf[:f]) + sum(tq[:f])
        for c0 in range(0, nb, 64):
            pf = int(ln[:c0][~sp[:c0], 0].sum())
            pq = int(ln[:c0][sp[:c0]].sum())
            chunk = range(c0, min(nb, c0 + 64))
            kf = [0 if sp[b] else int(ln[b, 0]) for b in chunk]
            kq = [int(ln[b].sum()) if sp[b] else 0 for b in chunk]
            for i, b in enumerate(chunk):
                if not sp[b]:
                    pos = base + pf + sum(kf[:i])
                    syms, _ = _warp_unit(qf[b][sf])
                    out[pos: pos + len(syms)] = syms
                else:
                    pos = base + tf[f] + pq + sum(kq[:i])
                    for q in range(4):
                        syms, length = _warp_unit(qq[b, q][sq])
                        out[pos: pos + length] = syms
                        pos += length
    return out


@pytest.mark.parametrize("n,nb", [(16, 70), (8, 130), (4, 67)])
def test_kernel_rule_transcription_equals_plain_version(n, nb):
    """Blocks spanning several 64-block chunks of a frame; scalar and
    triple MVs; all six kinds of block in one segment."""
    rng = np.random.default_rng(n + nb)
    kinds = ["random", "alternating", "extremes", "trailing", "nonzero"]
    fr = _frames(rng, n, nb, kinds, ["some", "none", "all", "some", "some"])
    fr["qtc_full"][0][::5] = 0
    sizes = [sum(len(x) for x in _reference(fr, f, n)[::2]) for f in range(len(kinds))]
    buf = _pack(fr, sum(sizes))
    _, s0 = K.rle_pack_layout(len(kinds), nb)
    np.testing.assert_array_equal(_kernel_transcription(fr, n, sum(sizes)), buf[s0:])


def test_mv_range_and_capacity_flags():
    """An unsplit block's MV outside int16 sets bit 0 (a split block's sub-MV
    too; a split block's MV and an unsplit block's sub-MVs are not written);
    symbols past ``cap`` are dropped and set bit 1."""
    rng = np.random.default_rng(2)
    nb, n = 12, 16
    fr = _frames(rng, n, nb, ["random", "random"], ["some", "some"])
    size = sum(sum(len(x) for x in _reference(fr, f, n)[::2]) for f in range(2))
    a, s0 = K.rle_pack_layout(2, nb)

    def flag(cap=size):
        return int(_pack(fr, cap)[8:a].view(np.int32)[0])

    sp = fr["split"][1].numpy()
    assert flag() == 0
    fr["mv"][1][np.flatnonzero(sp)[0], 0] = 40000
    fr["sub_mv"][1][np.flatnonzero(~sp)[0], 2, 1] = -40000
    assert flag() == 0
    fr["sub_mv"][1][np.flatnonzero(sp)[0], 1, 1] = 32768
    assert flag() == 1
    fr["sub_mv"][1][np.flatnonzero(sp)[0], 1, 1] = 32767
    fr["mv"][0][np.flatnonzero(~fr["split"][0].numpy())[0]] = -32769
    assert flag() == 1
    fr["mv"][0][:] = 0
    assert flag(size - 1) == 2
    np.testing.assert_array_equal(_pack(fr, size - 5)[s0:], _pack(fr, size)[s0: s0 + size - 5])


def test_wrapper_refuses_what_it_does_not_take():
    rng = np.random.default_rng(4)
    fr = _frames(rng, 16, 6, ["random", "random"], ["some", "some"])

    def call(**repl):
        args = {k: list(v) for k, v in fr.items()}
        for k, v in repl.items():
            args[k][1] = v
        return K.rle_pack(args["split"], args["mv"], args["sub_mv"], args["qtc_full"], args["qtc_quads"], 10 ** 4)

    call()
    with pytest.raises(TypeError):
        call(qtc_full=fr["qtc_full"][1].to(torch.int32))
    with pytest.raises(TypeError):
        call(split=fr["split"][1].to(torch.uint8))
    with pytest.raises(ValueError):
        call(sub_mv=fr["sub_mv"][1][:, :, 0].contiguous())  # scalar sub-MVs beside triple MVs
    with pytest.raises(ValueError):
        call(qtc_quads=fr["qtc_quads"][1].transpose(-1, -2))
    with pytest.raises(ValueError):
        K.rle_pack([], [], [], [], [], 0)
    with pytest.raises(ValueError):
        K.rle_pack(fr["split"], fr["mv"], fr["sub_mv"], fr["qtc_full"], fr["qtc_quads"][:1], 100)


# ------------------------------------------------------------ container level
CASES = {
    "whole_pel": {},
    "vbs": {"vbs_enable": True},
    "fme": {"fme_enable": True},
    "fast_vbs_fme": {"fast_me": True, "search_range": 16, "vbs_enable": True, "fme_enable": True},
    "rc_vbs": {**RC, "vbs_enable": True},
    "roi_vbs_fme": {"roi_qp_map": ROI, "vbs_enable": True, "fme_enable": True},
    "intra_mode_1": {"intra_mode": 1, "vbs_enable": True},
}


def _kw(**kw):
    base = dict(height=64, width=96, frames=5, block_size=16, search_range=3, qp=4, intra_dur=3, lam=0.015)
    base.update(kw)
    return base


@pytest.mark.parametrize("name", list(CASES))
def test_coded_route_writes_the_host_route_and_jax_bytes(tmp_path, name):
    """The same encode written from its tensors (the coded route, the plain
    ``rle_pack`` on the CPU) and from its list package (the host route):
    one file, the JAX package's; ``rle_frames`` says which route coded."""
    y = synthetic_clip(64, 96, 5)
    kw = _kw(**CASES[name])
    tracer.enable()
    coded = VideoCodec(CodecConfig(**kw), y, device="cpu")
    pkg = coded.encode(compute_ssim=False, package=False)
    tracer.reset()
    coded.transmit_bitstream_binary(tmp_path / "coded.sob")
    assert tracer.snapshot()["rle_frames"] == {"device": 5}
    host = VideoCodec(CodecConfig(**kw), y, device="cpu")
    host.encode(compute_ssim=False)
    tracer.reset()
    host.transmit_bitstream_binary(tmp_path / "host.sob")
    assert tracer.snapshot()["rle_frames"] == {"host": 5}
    tracer.disable()
    jv = JaxVideoCodec(JaxCodecConfig(**kw), y)
    jv.encode(package=False)
    jv.transmit_bitstream_binary(tmp_path / "jax.sob")
    data = (tmp_path / "coded.sob").read_bytes()
    assert data == (tmp_path / "host.sob").read_bytes() == (tmp_path / "jax.sob").read_bytes()
    assert any(int(o["split"].sum()) for o in pkg["per_frame"]) == bool(kw.get("vbs_enable"))
    bare = {k: v for k, v in kw.items() if k != "roi_qp_map"}
    dec = VideoCodec(CodecConfig(**bare), device="cpu").decode_bitstream_binary(tmp_path / "coded.sob")
    np.testing.assert_array_equal(dec, pkg["reconstructed frames"])


def test_coded_route_on_a_cpu_mesh(tmp_path):
    """A mesh's ``package=False`` encode (its tensors on the first device)
    takes the coded route: the single device's host-route file."""
    clip = synthetic_clip(64, 64, 6)
    cfg = CodecConfig(height=64, width=64, frames=6, block_size=16, search_range=4, qp=3, intra_dur=3,
                      vbs_enable=True, fme_enable=True)
    mesh = make_mesh(cfg, devices=["cpu"] * 8)
    tracer.enable()
    on_mesh = VideoCodec(dataclasses.replace(cfg), clip, mesh=mesh)
    on_mesh.encode(compute_ssim=False, package=False)
    tracer.reset()
    on_mesh.transmit_bitstream_binary(tmp_path / "mesh.sob")
    assert tracer.snapshot()["rle_frames"] == {"device": 6}
    one = VideoCodec(dataclasses.replace(cfg), clip, device="cpu")
    one.encode(compute_ssim=False)
    one.transmit_bitstream_binary(tmp_path / "one.sob")
    assert (tmp_path / "mesh.sob").read_bytes() == (tmp_path / "one.sob").read_bytes()


@pytest.mark.parametrize("delta", [-1, 1])
def test_coded_totals_must_equal_the_residual_sizes(tmp_path, delta):
    """A frame whose coded lists add up to other than the package's residual
    size raises, a short buffer and a long one alike; an MV outside int16
    raises as the host route does."""
    y = synthetic_clip(64, 96, 4)
    v = VideoCodec(CodecConfig(**_kw(frames=4, vbs_enable=True)), y, device="cpu")
    pkg = v.encode(compute_ssim=False, package=False)
    sizes = list(pkg["residual size per frame"])
    sizes[2] += delta
    with pytest.raises(ValueError, match="residual sizes"):
        binstream.coded_frames_of(pkg["per_frame"], pkg["frame_type_seq"], sizes)
    o = pkg["per_frame"][1]
    o["mv"] = o["mv"].clone()
    o["mv"][int(torch.nonzero(~o["split"])[0]), 1] = 40000 * delta
    with pytest.raises(ValueError, match="mv outside int16 range"):
        v.transmit_bitstream_binary(tmp_path / "big.sob")
