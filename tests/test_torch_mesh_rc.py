"""PyTorch port, rate control on the mesh: per-row QPs, ROI maps,
scene-change promotion and two-pass.

The port's ``ShardedCodec`` on an 8-device CPU mesh (``devices=["cpu"] *
8``) on ``tests/test_parallel.py``'s rate-control cases (``CASES[5]``,
``test_sharded_roi``, ``test_sharded_accepts_two_pass``, the ``rc1`` decode
case, promotion alone and with two-pass on ``_scene_cut_clip``, two-pass
with VBS), and on promotion with fast ME + VBS + FME, two-pass with an ROI
map and intra mode 1 with an ROI map.  Each is held against the JAX
package's ``JaxCodec`` (``_compare_packages``, PSNR to 1e-4: float32 in
another order; frame types and row QPs exactly) and against the port's
``TorchCodec`` on one device, bit for bit; the mesh's decode of its own
package equals its reconstructions and ``JaxCodec``'s decode of the same
lists.  The JAX ``ShardedCodec`` is not run: its XLA:CPU collectives are
what aborts test workers under load.
"""
import numpy as np
import pytest
import torch

from conftest import smooth_clip, synthetic_clip
from test_parallel import CASES, RC_TABLES, _compare_packages, _scene_cut_clip

from streamoptima_tpu import CodecConfig as JaxCodecConfig
from streamoptima_tpu.jax_engine import JaxCodec
from streamoptima_tpu_torch import CodecConfig
from streamoptima_tpu_torch.engine import TorchCodec
from streamoptima_tpu_torch.parallel import ShardedCodec, make_mesh

torch.set_num_threads(1)
CPU8 = ["cpu"] * 8
KW = dict(height=64, width=64, frames=6, block_size=16, search_range=4, qp=3, intra_dur=3)  # test_parallel's
RC1 = CASES[5]
PROMOTE = dict(height=64, width=64, frames=6, search_range=4, qp=4, intra_dur=3, rc_flag=2, target_br="100 mbps",
               frame_rate=30, qp_rate_tables=RC_TABLES, intra_thresh=3800)
ROI44 = np.zeros((4, 4), dtype=np.int32)
ROI44[1:3, 1:3] = -2  # better quality in the middle (test_sharded_roi's)
ROI34 = np.arange(12, dtype=np.int32).reshape(3, 4) % 5 - 2


def _moving(h, w, frames, motion):
    return lambda: synthetic_clip(h=h, w=w, frames=frames, motion=motion)


def _cut():
    return _scene_cut_clip(64, 64, 6, cut=4)


#: name -> (config, clip, expected mesh shape)
MESH_RC = {
    "rc1": (dict(KW, **RC1), _moving(64, 64, 6, 2), (2, 4)),  # CASES[5]
    "roi": (dict(height=64, width=64, frames=4, search_range=4, qp=5, intra_dur=2, roi_qp_map=ROI44),
            _moving(64, 64, 4, 1), (2, 4)),  # test_sharded_roi
    "rc1_decode": (dict(KW, qp=4, **RC1), _moving(64, 64, 6, 2), (2, 4)),  # test_sharded_decode_..., rc1
    "promotion": (PROMOTE, _cut, (2, 4)),
    "promotion_two_pass": (dict(PROMOTE, two_pass=True), _cut, (2, 4)),
    "two_pass_vbs": (dict(KW, qp=4, vbs_enable=True, lam=0.015, two_pass=True, **RC1), _moving(64, 64, 6, 2),
                     (2, 4)),
    "promotion_fast_vbs_fme": (dict(PROMOTE, fast_me=True, vbs_enable=True, fme_enable=True, lam=0.015), _cut,
                               (2, 4)),
    "two_pass_roi": (dict(KW, qp=4, two_pass=True, roi_qp_map=ROI44, **RC1), _moving(64, 64, 6, 2), (2, 4)),
    "intra1_roi": (dict(height=48, width=64, frames=4, search_range=4, qp=4, intra_dur=2, intra_mode=1,
                        roi_qp_map=ROI34), lambda: smooth_clip(h=48, w=64, frames=4, motion=2), (8, 1)),
}


def _lists(pkg):
    return pkg["frame_type_seq"], pkg["approx residual"], pkg["Qp_per_row_per_frame"], pkg["MVS per Frame"]


@pytest.fixture(scope="module", params=list(MESH_RC), ids=list(MESH_RC))
def case(request):
    """One case: JaxCodec's, TorchCodec's and the port mesh's encodes, and
    the mesh codec."""
    kw, make_clip, shape = MESH_RC[request.param]
    clip = make_clip()
    cfg = CodecConfig(**kw)
    mesh = make_mesh(cfg, devices=CPU8)
    assert mesh.devices.shape == shape
    sc = ShardedCodec(cfg, mesh, clip)
    return {"name": request.param, "kw": kw, "jpkg": JaxCodec(JaxCodecConfig(**kw), clip).encode(),
            "tpkg": TorchCodec(cfg, clip, device="cpu").encode(), "sc": sc, "pkg": sc.encode()}


def test_mesh_rc_matches_jax_codec(case):
    jpkg, pkg = case["jpkg"], case["pkg"]
    _compare_packages(jpkg, pkg)
    assert pkg["frame_type_seq"] == jpkg["frame_type_seq"]
    assert pkg["Qp_per_row_per_frame"] == jpkg["Qp_per_row_per_frame"]


def test_mesh_rc_matches_torch_codec_bit_for_bit(case):
    a, b = case["pkg"], case["tpkg"]
    for k in ("frame_type_seq", "Qp_per_row_per_frame", "residual size per frame", "PSNR per frame",
              "MAE per Frame", "MVS per Frame"):
        assert a[k] == b[k], k
    np.testing.assert_array_equal(a["reconstructed frames"], b["reconstructed frames"])
    _compare_packages(a, b)


def test_mesh_rc_decode_equals_recon_and_jax_decode(case):
    """The sharded decode == the reconstructions == JaxCodec's decode of the
    same lists (the stream's row QPs, each tile its rows)."""
    args = _lists(case["pkg"])
    dec = torch.stack(case["sc"].decode(*args)).numpy()
    np.testing.assert_array_equal(dec, case["pkg"]["reconstructed frames"])
    jdec = JaxCodec(JaxCodecConfig(**case["kw"])).decode(*args)
    np.testing.assert_array_equal(dec, np.stack([np.asarray(f) for f in jdec]))


def test_mesh_rc_decodes_the_jax_codec_stream(case):
    dec = case["sc"].decode(*_lists(case["jpkg"]))
    np.testing.assert_array_equal(torch.stack(dec).numpy(), case["jpkg"]["reconstructed frames"])


def test_mesh_rc_cases_exercise_their_feature(case):
    """Each case codes what it names: the cut promotes frame 4 and no
    static frame; rate control leaves the rows' QPs, and two-pass moves
    them off the table rows; the ROI map reaches the block QPs."""
    pkg, name, kw = case["pkg"], case["name"], case["kw"]
    fts, qps = pkg["frame_type_seq"], pkg["Qp_per_row_per_frame"]
    if name.startswith("promotion"):
        assert fts[4] == 0 and fts[1] == 1 and fts[3] == 0
    else:
        assert fts == [0 if i % kw["intra_dur"] == 0 else 1 for i in range(kw["frames"])]
    if "rc_flag" in kw:
        assert all(len(r) == 4 for r in qps)
        table = case["sc"].row_qps_np
        on_table = all(r == table[ft].tolist() for r, ft in zip(qps, fts))
        if not kw.get("two_pass"):
            assert on_table, qps
        elif kw["target_br"] == RC1["target_br"]:  # at 100 mbps every row takes QP 0 either way
            assert not on_table, qps
    else:
        assert qps == [[]] * kw["frames"]
    if "roi_qp_map" in kw:  # without the map the same clip codes other sizes
        plain = {k: v for k, v in kw.items() if k != "roi_qp_map"}
        bare = TorchCodec(CodecConfig(**plain), MESH_RC[name][1](), device="cpu").encode()
        assert bare["residual size per frame"] != pkg["residual size per frame"]


def test_mesh_constructs_and_encodes_two_pass():
    """``test_sharded_accepts_two_pass``'s config: the mesh takes it, and
    encodes it as one device does."""
    cfg = CodecConfig(height=64, width=64, frames=2, search_range=2, two_pass=True, rc_flag=1, target_br="100 kbps",
                      qp_rate_tables=[[9000, 4000, 2000, 1100, 800, 600, 450, 350, 280, 230, 200, 180]] * 2)
    clip = synthetic_clip(h=64, w=64, frames=2)
    pkg = ShardedCodec(cfg, make_mesh(cfg, devices=CPU8), clip).encode()
    tpkg = TorchCodec(cfg, clip, device="cpu").encode()
    for k in ("frame_type_seq", "Qp_per_row_per_frame", "residual size per frame", "PSNR per frame"):
        assert pkg[k] == tpkg[k], k


def test_mesh_promotion_fast_me_passes_and_mvs():
    """Fast ME across a promoted frame: the chain's fixpoint is unique, so
    the MVs are the single device's whatever the warm start; the mesh
    records one pass count per inter step it ran (the promoted frame's
    too), each at least one pass."""
    kw = MESH_RC["promotion_fast_vbs_fme"][0]
    clip = _cut()
    cfg = CodecConfig(**kw)
    pkg = ShardedCodec(cfg, make_mesh(cfg, devices=CPU8), clip).encode(package=False)
    tpkg = TorchCodec(cfg, clip, device="cpu").encode(package=False)
    assert pkg["frame_type_seq"] == tpkg["frame_type_seq"] == [0, 1, 1, 0, 0, 1]
    assert len(pkg["fast_me_passes"]) == len(tpkg["fast_me_passes"]) == 4  # frames 1, 2, 4 (promoted), 5
    assert min(pkg["fast_me_passes"]) >= 1
    for fa, fb in zip(pkg["per_frame"], tpkg["per_frame"]):
        for k in ("mv", "split", "sub_mv", "qtc_full", "qtc_quads", "row_bits", "recon"):
            assert torch.equal(fa[k], fb[k]), k


def test_dryrun_multichip_on_the_cpu(capsys):
    from streamoptima_tpu_torch.parallel.dryrun import CASES as DRY, dryrun_multichip

    assert set(DRY) == {"vbs_fme", "fast_me_vbs_fme", "promotion_two_pass", "roi_map", "intra_mode1", "nref4"}
    dryrun_multichip(8, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 7 and out[-1].startswith("dryrun ok: mesh=(data=2, tile=4) of cpu, 6 feature sets")
