"""nerftex_torch's CUDA kernels against their plain PyTorch versions on the
card (marked gpu; each test skips without a CUDA device).  On a machine
with a card:  python -m pytest tests/test_torch_cuda.py -m gpu"""

import numpy as np
import pytest
import torch

from nerftex_torch.kernels import mlp_fused as fused
from nerftex_torch.kernels import tex_gather
from nerftex_torch.utils.util import instantiate

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_tex_fetch_kernel_matches_plain(cuda):
    """The f32 variant on channels that are not byte valued."""
    rs = np.random.RandomState(0)
    for w, h in ((256, 256), (60, 40)):
        tex = torch.tensor(rs.rand(w, h).astype(np.float32), device=cuda)
        assert tex_gather.byte_quads(tex) is None
        uv = torch.tensor(rs.uniform(-0.1, 1.1, (3, 1000, 2)).astype(np.float32), device=cuda)
        before = tex_gather.sample_channel.launches
        variants = dict(tex_gather.sample_channel.variant_launches)
        got = tex_gather.sample_channel(tex, uv)
        assert tex_gather.sample_channel.launches == before + 1
        assert tex_gather.sample_channel.variant_launches == dict(variants, f32=variants["f32"] + 1)
        # Both round every lerp operation separately: bit-equal.
        assert torch.equal(got, tex_gather.sample_channel_plain(tex, uv))


def test_tex_fetch_byte_quad_kernel_matches_plain(cuda):
    """The byte_quad variant on byte-valued channels, odd dims and a
    sample count that is not a multiple of the block: bit-equal to both
    plain versions."""
    rs = np.random.RandomState(5)
    for w, h in ((256, 256), (61, 37), (2, 9)):
        tex = torch.tensor(rs.randint(0, 256, (w, h)).astype(np.float32) / np.float32(255.0),
                           device=cuda)
        quads = tex_gather.byte_quads(tex)
        assert quads is not None and quads.device == tex.device
        uv = torch.tensor(rs.uniform(-0.1, 1.1, (3, 1001, 2)).astype(np.float32), device=cuda)
        variants = dict(tex_gather.sample_channel.variant_launches)
        got = tex_gather.sample_channel(tex, uv, quads)
        assert tex_gather.sample_channel.variant_launches == dict(
            variants, byte_quad=variants["byte_quad"] + 1)
        assert torch.equal(got, tex_gather.sample_channel_plain(tex, uv))
        assert torch.equal(got, tex_gather.fetch_quads_plain(quads, w, h, uv))


def test_tex_fetch_kernel_refuses_bad_inputs(cuda):
    tex = torch.rand(8, 8, device=cuda)
    with pytest.raises(TypeError):
        tex_gather.sample_channel(tex, torch.rand(5, 2, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        tex_gather.sample_channel(tex, torch.rand(2, 5, device=cuda).T)
    with pytest.raises(ValueError):  # uv not 8-byte aligned
        tex_gather.sample_channel(tex, torch.rand(23, device=cuda)[1:].view(11, 2))
    with pytest.raises(ValueError):  # a quad table of other dims
        tex_gather.sample_channel(tex, torch.rand(5, 2, device=cuda),
                                  torch.zeros(8, 8, 4, dtype=torch.uint8, device=cuda))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_mlp_fused_kernel_matches_plain(cuda, dtype, tol):
    ff = {"module": "network.model.FourierFeatures", "n_freq_bands": 4}
    model = instantiate({"module": "network.model.ParamNerf", "pos_embedding": ff,
                         "dir_embedding": ff, "param_embedding": ff, "n_parameters": [1, 6],
                         "depth": 4, "width": 128, "skips": [1], "compute_dtype": dtype},
                        device=cuda)
    rs = np.random.RandomState(1)
    n = 1000                                   # not a multiple of the 64- or 128-row tile
    pos, dirs, prm = (torch.tensor(rs.uniform(-1, 1, (n, k)).astype(np.float32), device=cuda)
                      for k in (3, 3, 7))
    pos_map, dir_map = model.feature_maps(pos, dirs, prm)
    packed = model.packed()
    before = fused.mlp_fused.launches
    got = fused.mlp_fused(pos_map, dir_map, packed)
    assert fused.mlp_fused.launches == before + 1
    ref = fused.mlp_fused_plain(pos_map, dir_map, packed)
    scale = max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= tol * scale


# The frames' ParamNerf topologies at full width and depth (bench:
# chip_smoke.model_config, plush: configs/config_plush_render.py,
# grass_filtered: configs/config_grass_filtered_render.py, pos map 81 and
# dir map 54 wide).
TOPOLOGIES = {"bench": {"n_parameters": [1, 6]},
              "plush": {"n_parameters": [1, 4], "param_depth": 0, "color_depth": 1},
              "grass_filtered": {"n_parameters": [2, 3]}}


@pytest.mark.parametrize("n", [1, 127, 1000, 32768 + 37])
@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
def test_mlp_wgmma_matches_plain(cuda, topology, n):
    """The bf16 wgmma variant with random nonzero biases, on tile counts
    below, at and above one tile per SM and ragged last tiles."""
    def ff(bands):
        return {"module": "network.model.FourierFeatures", "n_freq_bands": bands}

    model = instantiate(dict({"module": "network.model.ParamNerf", "pos_embedding": ff(10),
                              "dir_embedding": ff(4), "param_embedding": ff(4),
                              "compute_dtype": "bfloat16"}, **TOPOLOGIES[topology]), device=cuda)
    rs = np.random.RandomState(7)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Linear):
                m.bias.copy_(torch.tensor(rs.uniform(-0.2, 0.2, m.bias.shape).astype(np.float32)))
    pos = torch.tensor(rs.uniform(-1, 1, (n, 3)).astype(np.float32), device=cuda)
    dirs = torch.nn.functional.normalize(
        torch.tensor(rs.normal(size=(n, 3)).astype(np.float32), device=cuda), dim=-1)
    prm = torch.tensor(rs.uniform(0, 1, (n, model.n_geo + model.n_app)).astype(np.float32),
                       device=cuda)
    pos_map, dir_map = model.feature_maps(pos, dirs, prm)
    packed = model.packed()
    before = fused.mlp_fused.variant_launches["wgmma_bf16"]
    got = fused.mlp_fused(pos_map, dir_map, packed)
    assert fused.mlp_fused.variant_launches["wgmma_bf16"] == before + 1
    ref = fused.mlp_fused_plain(pos_map, dir_map, packed)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    scale = max(1.0, float(ref.abs().max()))
    print(f"{topology} N={n}: max |kernel - plain| {float(err.max()):.3g}, "
          f"mean {float(err.mean()):.3g}, max |plain| {scale:.3g}")
    assert torch.isfinite(got).all()
    assert float(err.max()) <= 5e-2 * scale


@pytest.mark.parametrize("n", [1, 127, 1000, 32768 + 37])
@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
def test_mlp_tf32x3_matches_plain(cuda, topology, n):
    """The f32 variant (3xTF32 wgmma) with random nonzero biases, on tile
    counts below, at and above one tile per SM and ragged last tiles, at
    chip_smoke.py's f32 tolerance against the plain version (cuBLAS in
    f32, TF32 off)."""
    def ff(bands):
        return {"module": "network.model.FourierFeatures", "n_freq_bands": bands}

    model = instantiate(dict({"module": "network.model.ParamNerf", "pos_embedding": ff(10),
                              "dir_embedding": ff(4), "param_embedding": ff(4)},
                             **TOPOLOGIES[topology]), device=cuda)
    rs = np.random.RandomState(8)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Linear):
                m.bias.copy_(torch.tensor(rs.uniform(-0.2, 0.2, m.bias.shape).astype(np.float32)))
    pos = torch.tensor(rs.uniform(-1, 1, (n, 3)).astype(np.float32), device=cuda)
    dirs = torch.nn.functional.normalize(
        torch.tensor(rs.normal(size=(n, 3)).astype(np.float32), device=cuda), dim=-1)
    prm = torch.tensor(rs.uniform(0, 1, (n, model.n_geo + model.n_app)).astype(np.float32),
                       device=cuda)
    pos_map, dir_map = model.feature_maps(pos, dirs, prm)
    packed = model.packed()
    before = dict(fused.mlp_fused.variant_launches)
    got = fused.mlp_fused(pos_map, dir_map, packed)
    assert fused.mlp_fused.variant_launches == dict(
        before, wgmma_tf32x3=before["wgmma_tf32x3"] + 1)
    ref = fused.mlp_fused_plain(pos_map, dir_map, packed)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    scale = max(1.0, float(ref.abs().max()))
    print(f"{topology} N={n}: max |kernel - plain| {float(err.max()):.3g}, "
          f"mean {float(err.mean()):.3g}, max |plain| {scale:.3g}")
    assert torch.isfinite(got).all()
    assert float(err.max()) <= 1e-4 * scale


@pytest.mark.parametrize("dtype,variant", [("float32", "wgmma_tf32x3"),
                                           ("bfloat16", "wgmma_bf16")])
def test_mlp_fused_rows_do_not_depend_on_the_launch(cuda, dtype, variant):
    """Each row's output is a function of that row alone: the rows of a
    32,768-row launch equal, bit for bit, the same rows inside a 1,000-row
    launch, wherever the 1,000 rows start (a tile boundary or not), so an
    MLP run over every slot of a block and masked gives its valid slots the
    values that the MLP on the gathered valid rows gives them."""
    def ff(bands):
        return {"module": "network.model.FourierFeatures", "n_freq_bands": bands}

    model = instantiate(dict({"module": "network.model.ParamNerf", "pos_embedding": ff(10),
                              "dir_embedding": ff(4), "param_embedding": ff(4),
                              "compute_dtype": dtype}, **TOPOLOGIES["bench"]), device=cuda)
    rs = np.random.RandomState(9)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Linear):
                m.bias.copy_(torch.tensor(rs.uniform(-0.2, 0.2, m.bias.shape).astype(np.float32)))
    n = 32768
    pos = torch.tensor(rs.uniform(-1, 1, (n, 3)).astype(np.float32), device=cuda)
    dirs = torch.nn.functional.normalize(
        torch.tensor(rs.normal(size=(n, 3)).astype(np.float32), device=cuda), dim=-1)
    prm = torch.tensor(rs.uniform(0, 1, (n, model.n_geo + model.n_app)).astype(np.float32),
                       device=cuda)
    pos_map, dir_map = model.feature_maps(pos, dirs, prm)
    packed = model.packed()
    before = dict(fused.mlp_fused.variant_launches)
    whole = fused.mlp_fused(pos_map, dir_map, packed)
    starts = (0, 128, 12345, n - 1000)
    parts = [fused.mlp_fused(pos_map[i:i + 1000], dir_map[i:i + 1000], packed) for i in starts]
    assert fused.mlp_fused.variant_launches == dict(
        before, **{variant: before[variant] + 1 + len(starts)})
    torch.cuda.synchronize()
    assert torch.isfinite(whole).all()
    for i, part in zip(starts, parts):
        assert torch.equal(part, whole[i:i + 1000]), i


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_fused_refuses_bad_inputs(cuda, dtype):
    """Maps of another dtype, width or device than the packed weights, or
    weights of an unsupported dtype, raise before any launch."""
    ff = {"module": "network.model.FourierFeatures", "n_freq_bands": 2}
    model = instantiate({"module": "network.model.ParamNerf", "pos_embedding": ff,
                         "dir_embedding": ff, "param_embedding": ff, "n_parameters": [1, 2],
                         "depth": 2, "width": 64, "skips": [0], "compute_dtype": dtype},
                        device=cuda)
    packed = model.packed()
    pos = torch.rand(10, packed.pos_dim, device=cuda)
    dirs = torch.rand(10, packed.dir_dim, device=cuda)
    launches = fused.mlp_fused.launches
    with pytest.raises(TypeError):
        fused.mlp_fused(pos.double(), dirs, packed)
    with pytest.raises(TypeError):
        fused.mlp_fused(pos.half(), dirs.half(), packed)
    with pytest.raises(ValueError):
        fused.mlp_fused(pos[:, 1:], dirs, packed)
    with pytest.raises(ValueError):
        fused.mlp_fused(pos, dirs[:5], packed)
    with pytest.raises(ValueError):
        fused.mlp_fused(pos, dirs.cpu(), packed)
    with pytest.raises(TypeError):
        fused.mlp_fused(pos, dirs, fused.PackedMLP(**dict(vars(packed), dtype=torch.float16)))
    assert fused.mlp_fused.launches == launches
    assert fused.mlp_fused(pos, dirs, packed).shape == (10, 4)


def selk_inputs(rs, rb, s, k, device="cpu"):
    """Random overlap-resolution inputs (tests/test_selk_kernel.py's recipe
    in numpy): valid slots at random, one all-invalid ray, one ray whose
    intervals no sample reaches."""
    tk0 = rs.uniform(0.0, 2.0, (rb, k))
    tk1 = tk0 + rs.uniform(0.05, 0.8, (rb, k))
    kvalid = rs.uniform(size=(rb, k)) > 0.3
    kvalid[0] = False
    tk0[1], tk1[1] = tk0[1] + 10.0, tk1[1] + 10.0
    c = rs.uniform(0.0, 2.5, (rb, k))
    sel_a = c * c + rs.uniform(0.0, 0.2, (rb, k))
    t_pt = rs.uniform(-0.1, 2.6, (rb, s))
    u_sel = rs.uniform(size=(rb, s))

    def f32(x):
        return torch.tensor(x.astype(np.float32), device=device)

    return (f32(tk0), f32(tk1), torch.tensor(kvalid, device=device), f32(sel_a), f32(-c),
            f32(t_pt), f32(u_sel))


@pytest.mark.parametrize("method", ["random", "nearest", "nearest_blend"])
def test_selk_kernel_matches_plain(cuda, method):
    from nerftex_torch.kernels import selk_resolve as selk

    rs = np.random.RandomState(2)
    args = selk_inputs(rs, 37, 45, 5, cuda)         # 37 rays: not a multiple of the tile
    before = selk.selk_resolve.launches
    sel, p, n = selk.selk_resolve(*args, method=method, blend_range=0.15)
    assert selk.selk_resolve.launches == before + 1
    ref_sel, ref_p, ref_n = selk.selk_resolve_plain(*args, method=method, blend_range=0.15)
    torch.cuda.synchronize()
    assert torch.equal(n, ref_n)
    assert (n[0] == 1).all() and (sel[0] == 0).all()
    same = sel == ref_sel
    if method != "nearest_blend":
        assert same.all()
    else:
        # The kernel sums the weights and the cumsum in slot order, the
        # plain version in PyTorch's reduction order: a pick may differ only
        # where u sits within 1e-5 of a cum value (tests/test_selk_kernel.py).
        assert same.float().mean() > 0.99
        if not same.all():
            cum = _blend_cum(selk, *args, 0.15)
            edge = (args[-1][..., None] - cum).abs().min(-1).values
            assert (edge[~same] <= 1e-5).all()
    torch.testing.assert_close(p[same], ref_p[same], rtol=1e-5, atol=1e-7)


def _blend_cum(selk, tk0, tk1, kvalid, sel_a, sel_b, t_pt, u_sel, blend):
    """The plain version's nearest_blend cumsum [Rb, S, K], for knife-edge
    checks."""
    K = tk0.shape[-1]
    tp = t_pt[..., None]
    active = kvalid[:, None] & (tk0[:, None] <= tp) & (tp < tk1[:, None])
    iv = torch.maximum(tk0[:, None] - tp, tp - tk1[:, None])
    iv = torch.where(kvalid[:, None], iv.clamp(min=0), float("inf"))
    fb = torch.nn.functional.one_hot(iv.argmin(-1), K).bool()
    active = torch.where((active.sum(-1) == 0)[..., None], fb, active)
    d2 = selk.anchor_d2(sel_a[:, None], sel_b[:, None], tp).clamp(min=0)
    dist = torch.where(active, d2.sqrt(), float("inf"))
    w = torch.where(active, (blend + dist.min(-1, keepdim=True).values - dist).clamp(min=0), 0.0)
    return torch.cumsum(w / w.sum(-1, keepdim=True).clamp(min=1e-20), -1)


def _tensors(device, tk0, tk1, kvalid, sel_a, sel_b, t_pt, u_sel):
    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return (f32(tk0), f32(tk1), torch.tensor(kvalid, device=device), f32(sel_a), f32(sel_b),
            f32(t_pt), f32(u_sel))


def _render_layout(rs, rb, s, k):
    """The render path's layout: valid slots a prefix ascending in tk0
    (tk0 = tk1 = +inf past it; some rays empty, some full), t increasing
    along S from before the first interval, through the gaps, to past the
    last one (padded samples)."""
    n_valid = rs.randint(0, k + 1, rb)
    n_valid[1::5] = k
    n_valid[::7] = 0
    kvalid = np.arange(k)[None, :] < n_valid[:, None]
    tk0 = np.sort(rs.uniform(0.5, 3.0, (rb, k)), -1)
    tk1 = tk0 + rs.uniform(0.01, 0.3, (rb, k))
    first = np.where(n_valid > 0, tk0[:, 0], 1.0) - 0.2
    last = np.where(n_valid > 0, np.where(kvalid, tk1, -np.inf).max(-1), 2.0) + 0.3
    t_pt = first[:, None] + (last - first)[:, None] * np.sort(rs.uniform(size=(rb, s)), -1)
    c = rs.uniform(0.5, 3.0, (rb, k))
    return (np.where(kvalid, tk0, np.inf), np.where(kvalid, tk1, np.inf), kvalid,
            c * c + rs.uniform(0, 0.01, (rb, k)), -c, t_pt, rs.uniform(size=(rb, s)))


def _ties(rs, rb, s, k):
    """Samples before, between and after all intervals, with exact distance
    ties between the first slot past t and the slot of the largest tk1 below
    it, and ties of the rounded distance t - tk1 far past every interval."""
    tk0 = np.full((rb, k), np.inf)
    tk1 = np.full((rb, k), np.inf)
    t_pt = np.zeros((rb, s))
    for r in range(rb):
        if r % 3 == 0:   # t = 2.5 is 0.5 from slot 0's end and from slot 2's start
            tk0[r, :4], tk1[r, :4] = [1.0, 1.25, 3.0, 3.5], [2.0, 1.5, 4.0, 5.0]
            t_pt[r] = np.linspace(0.0, 6.0, s)
            t_pt[r, :4] = [2.5, 2.5, 0.5, 5.5]
        elif r % 3 == 1:  # tk1 = 1 and 1 + ulp: t - tk1 rounds equal for large t
            tk0[r, :4] = [0.5, 0.6, 0.7, 0.8]
            tk1[r, :4] = [1.0, np.nextafter(np.float32(1.0), np.float32(2.0)), 0.9, 1.0]
            t_pt[r] = np.linspace(1000.0, 1e6, s)
        else:             # nested and touching intervals
            tk0[r, :4], tk1[r, :4] = [0.0, 0.0, 1.0, 1.0], [1.0, 3.0, 2.0, 1.0 + 1e-7]
            t_pt[r] = np.linspace(-1.0, 4.0, s)
            t_pt[r, :3] = [1.0, 3.0, 0.0]
    c = rs.uniform(0.0, 2.5, (rb, k))
    return tk0, tk1, np.isfinite(tk0), c * c, -c, t_pt, rs.uniform(size=(rb, s))


def _wide(rs, rb, s, k):
    """Every slot overlaps every other and every anchor lies within the
    blend range of the nearest: more weighed slots than the kernel's
    candidate list holds."""
    tk0 = np.sort(rs.uniform(0.0, 0.1, (rb, k)), -1)
    tk1 = tk0 + rs.uniform(2.0, 3.0, (rb, k))
    c = rs.uniform(1.0, 1.05, (rb, k))
    return (tk0, tk1, np.ones((rb, k), bool), c * c, -c,
            np.sort(rs.uniform(-0.5, 3.5, (rb, s)), -1), rs.uniform(size=(rb, s)))


def _all_invalid(rs, rb, s, k):
    c = rs.uniform(0.0, 2.5, (rb, k))
    return (np.full((rb, k), np.inf), np.full((rb, k), np.inf), np.zeros((rb, k), bool),
            c * c, -c, rs.uniform(0.0, 3.0, (rb, s)), rs.uniform(size=(rb, s)))


def _general(rs, rb, s, k):
    return tuple(x.numpy() for x in selk_inputs(rs, rb, s, k))


# layout -> (inputs, Rb, S, K).  Rb 1001 with these S packs 3 rays per CTA
# and leaves a ragged last CTA; S 2500 splits each ray over two CTAs.
SELK_LAYOUTS = {
    "general": (_general, 61, 45, 33),
    "render_k1": (_render_layout, 1001, 40, 1),
    "render_k8": (_render_layout, 1001, 40, 8),
    "render_k32": (_render_layout, 1001, 40, 32),
    "render_k48": (_render_layout, 1001, 40, 48),
    "render_k128": (_render_layout, 300, 200, 128),
    "render_long": (_render_layout, 5, 2500, 8),
    "ties": (_ties, 31, 40, 8),
    "wide": (_wide, 40, 100, 48),
    "wide_k128": (_wide, 8, 300, 128),
    "all_invalid": (_all_invalid, 37, 45, 8),
}


@pytest.mark.parametrize("layout", sorted(SELK_LAYOUTS))
@pytest.mark.parametrize("method", ["random", "nearest", "nearest_blend"])
def test_selk_kernel_layouts_match_plain(cuda, method, layout):
    """The kernel against its plain version on each layout, launched once:
    nearest/random picks and n_active exact, nearest_blend picks off the
    cum's knife edges."""
    from nerftex_torch.kernels import selk_resolve as selk

    make, rb, s, k = SELK_LAYOUTS[layout]
    args = _tensors(cuda, *make(np.random.RandomState(11), rb, s, k))
    before = selk.selk_resolve.launches
    sel, p, n = selk.selk_resolve(*args, method=method, blend_range=0.15)
    assert selk.selk_resolve.launches == before + 1
    ref_sel, ref_p, ref_n = selk.selk_resolve_plain(*args, method=method, blend_range=0.15)
    torch.cuda.synchronize()
    assert torch.equal(n, ref_n)
    same = sel == ref_sel
    if method != "nearest_blend":
        assert same.all()
    elif not same.all():
        cum = _blend_cum(selk, *args, 0.15)
        edge = (args[-1][..., None] - cum).abs().min(-1).values
        assert (edge[~same] <= 1e-5).all()
    torch.testing.assert_close(p[same], ref_p[same], rtol=1e-5, atol=1e-7)


def test_render_session_serves_grass_on_the_card(cuda, tmp_path):
    """RenderSession(config_grass_render, operating_point="grass") on the
    card at 64x64, from a checkpoint of the full-width grass weights in the
    JAX package's layout: two requests run the wgmma MLP and the overlap
    pick (no texture fetch), and the first equals a direct render of its
    rays under stream_key(STREAM_PERTURB, 0) within 1e-6."""
    import importlib
    import os

    from nerftex_torch.kernels import selk_resolve as selk
    from nerftex_torch.render.checkpoint import CheckpointManager, unflatten_params
    from nerftex_torch.render.serve import RenderSession, straight_rgba
    from nerftex_torch.utils import rng

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = dict(importlib.import_module("configs.config_grass_render").config,
               target_path=str(tmp_path))
    cfg["renderer_config"] = dict(cfg["renderer_config"])
    inst = cfg["renderer_config"]["instancer_config"] = dict(
        cfg["renderer_config"]["instancer_config"])
    for k in ("mesh_path", "patch_origins_path"):
        inst[k] = os.path.join(root, inst[k])
    npz = np.load(os.path.join(root, "tests", "torch_grass_inputs.npz"))
    params = {k[len("param/"):]: npz[k] for k in npz.files if k.startswith("param/")}
    CheckpointManager(str(tmp_path / "checkpoints")).save(
        {"models": {"model": unflatten_params(params)}}, 1)
    session = RenderSession(cfg, height=64, width=64, operating_point="grass")
    assert session.device.type == "cuda" and session.restored_from.endswith("ckpt-1.pkl")
    counts = (fused.mlp_fused.variant_launches["wgmma_bf16"], selk.selk_resolve.launches,
              tex_gather.sample_channel.launches)
    first = session.render([0.30614675, -0.73910363, 0.6])
    second = session.render([0.0, -0.7, 0.7])
    assert fused.mlp_fused.variant_launches["wgmma_bf16"] > counts[0]
    assert selk.selk_resolve.launches > counts[1]
    assert tex_gather.sample_channel.launches == counts[2]
    for img in (first, second):
        assert img.shape == (64, 64, 4) and np.isfinite(img).all()
        assert img[..., 3].max() > 0.5
    rays_o, rays_d, t, cone = session.device_rays(session.pose([0.30614675, -0.73910363, 0.6]))
    out = session.renderer(rays_o=rays_o[None], rays_d=rays_d[None], t=t[None],
                           parameters=session.default_parameters[None], cone_scale=cone[None],
                           key=rng.stream_key(rng.STREAM_PERTURB, 0))
    direct = straight_rgba(out["color_pred"].cpu().numpy(), out["alpha_pred"].cpu().numpy(),
                           64, 64)
    assert np.abs(direct - first).max() <= 1e-6


def test_blur_sorted_frame_equals_dense_frame_on_the_card(cuda):
    """configs/config_grass_filtered_render.py (blur_idx 0, f32 ParamNerf
    with the committed grass_filtered weights) at 32x32 on the dataset's
    last item: the sorted path, which hands each block its rays'
    cone_scale, and the dense path scale the blur slot alike, through the
    f32 MLP kernel (wgmma_tf32x3); without blur_idx the frame differs."""
    import copy
    import importlib
    import os

    from nerftex_torch.render.checkpoint import load_jax_params
    from nerftex_torch.utils import jax_rng, rng

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = copy.deepcopy(importlib.import_module("configs.config_grass_filtered_render").config)
    cfg["test_dataset_config"]["data_loader_config"].update(height=32, width=32)
    rng.set_seed(cfg["seed"])
    data = list(instantiate(cfg["test_dataset_config"]))[-1]
    npz = np.load(os.path.join(root, "tests", "torch_grass_filtered_inputs.npz"))
    model = instantiate(dict(cfg["model_config"], n_parameters=[2, 3]), device=cuda)
    load_jax_params(model, {k[len("param/"):]: npz[k] for k in npz.files
                            if k.startswith("param/")})
    inst = cfg["renderer_config"]["instancer_config"]
    for k in ("mesh_path", "patch_origins_path"):
        inst[k] = os.path.join(root, inst[k])

    def render(**kw):
        r = instantiate(dict(cfg["renderer_config"], model=model, device=cuda, **kw))
        out = r(**data, key=jax_rng.key(1))
        return out["color_pred"].cpu().numpy(), out["alpha_pred"].cpu().numpy()

    before = fused.mlp_fused.variant_launches["wgmma_tf32x3"]
    c_s, a_s = render()
    assert fused.mlp_fused.variant_launches["wgmma_tf32x3"] > before
    c_d, a_d = render(sorted_blocks=False)
    assert a_s.max() > 0.5
    np.testing.assert_allclose(c_s, c_d, rtol=0, atol=5e-7)
    np.testing.assert_allclose(a_s, a_d, rtol=0, atol=5e-7)
    _, a_n = render(blur_idx=None)
    assert np.abs(a_n - a_s).max() > 1e-2


# (config, request): the carpet preview (no shadows) and a grass frame lit by
# its point light (z 0.6 on the unit sphere), so the shadow pass and its
# reads run.
HOST_READ_RENDERS = {
    "carpet": ([0.0, -0.7, 0.7], None),
    "grass": ([0.30614675, -0.73910363, 0.6], [0, 0.33, 0.47, -0.64, 0.6]),
}


def _host_read_session(name, tmp_path):
    """A 128x128 RenderSession of configs/config_<name>_render.py at the
    scene's operating point, the MLP in float32, random weights, after one
    request (which builds, packs and uploads once)."""
    import importlib
    import os

    from nerftex_torch import operating_points
    from nerftex_torch.render.serve import RenderSession

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = dict(importlib.import_module(f"configs.config_{name}_render").config,
               target_path=str(tmp_path))
    cfg["renderer_config"] = dict(cfg["renderer_config"])
    inst = cfg["renderer_config"]["instancer_config"] = dict(
        cfg["renderer_config"]["instancer_config"])
    for k in ("mesh_path", "patch_origins_path"):
        inst[k] = os.path.join(root, inst[k])
    inst["textures"] = [os.path.join(root, t) if t.endswith(".png") else t
                        for t in inst["textures"]]
    point = dict(operating_points.resolve(name), compute_dtype="float32")
    session = RenderSession(cfg, height=128, width=128, operating_point=point)
    session.render(*HOST_READ_RENDERS[name])
    torch.cuda.synchronize()
    return session


@pytest.mark.parametrize("name", sorted(HOST_READ_RENDERS))
def test_a_render_waits_for_the_card_only_in_host_reads(cuda, tmp_path, name):
    """A 128x128 frame of configs/config_<name>_render.py through
    RenderSession (_host_read_session) under the tracer's recording, with
    torch.cuda.set_sync_debug_mode("warn"): every call that synchronises
    with the card warns, and each warning comes while a sync.* span is
    open, so the tracer's sync count misses no host read of the path."""
    import traceback
    import warnings
    from collections import Counter

    from nerftex_torch.utils import trace

    session = _host_read_session(name, tmp_path)
    camera, parameters = HOST_READ_RENDERS[name]

    inside, outside = [], []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" not in str(message):
            return
        open_spans = trace.open_spans()
        if any(span.startswith("sync.") for span in open_spans):
            inside.append(open_spans[-1])
        else:
            where = [f"{f.filename}:{f.lineno}" for f in traceback.extract_stack()[-7:-1]]
            outside.append((open_spans[-1:], where))

    trace.reset()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with trace.recording():
                img = session.render(camera, parameters)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    snap = trace.snapshot()
    totals = trace.totals(snap)
    trace.reset()
    assert img.shape == (128, 128, 4) and np.isfinite(img).all()
    assert not outside, outside
    assert inside and totals["sync"] > 0
    # The per-ray stage reads nothing back: its kernels choose the culls'
    # branches on the card, and their counts are read with the tracer's.
    sites = Counter(s["name"] for s in snap["spans"] if s["name"].startswith("sync."))
    assert not {"sync.fan", "sync.cull"} & set(sites), sites
    assert totals["per_ray.kernel"] == totals["per_ray.rays"] > 0
    assert totals.get("cull.fit", 0) + totals.get("cull.full", 0) > 0
    if name == "grass":
        # The shadow pass ran its branch read; its shadowed samples take
        # the instancer's own light-down constant, with no read.
        assert "sync.shadow_branch" in set(inside), Counter(inside)
        assert "sync.light_down" not in sites, sites
        assert sum(totals.get(f"shadow.{k}", 0) for k in ("skip", "culled", "full")) > 0


@pytest.mark.parametrize("name", sorted(HOST_READ_RENDERS))
def test_the_sorted_block_loop_never_synchronises(cuda, tmp_path, monkeypatch, name):
    """The 128x128 frame of _host_read_session with
    torch.cuda.set_sync_debug_mode("error") from the end of each
    sync.block_table read to the next sync.overflow read: the sorted blocks
    (per-sample stage, the MLP over every slot, the composite) and the
    reorder behind them raise on any call that waits for the card.  The
    frame reads the host only at the pose, the copies, the keys, the block
    table, the drop counts, the read-back and (grass) the shadow branch."""
    from collections import Counter

    from nerftex_torch.utils import trace

    session = _host_read_session(name, tmp_path)
    real = trace.host_read
    armed = []

    class host_read(real):
        __slots__ = ()

        def __enter__(self):
            if self.name == "overflow":
                torch.cuda.set_sync_debug_mode("default")
            return real.__enter__(self)

        def __exit__(self, *exc):
            out = real.__exit__(self, *exc)
            if self.name == "block_table" and exc[0] is None:
                armed.append(self.name)
                torch.cuda.set_sync_debug_mode("error")
            return out

    monkeypatch.setattr(trace, "host_read", host_read)
    trace.reset()
    try:
        with trace.recording():
            img = session.render(*HOST_READ_RENDERS[name])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    snap = trace.snapshot()
    trace.reset()
    assert img.shape == (128, 128, 4) and np.isfinite(img).all()
    sites = Counter(s["name"] for s in snap["spans"] if s["name"].startswith("sync."))
    assert armed and sites["sync.block_table"] == len(armed), sites
    allowed = {"sync.pose", "sync.copy", "sync.keys", "sync.block_table", "sync.overflow",
               "sync.readback"} | ({"sync.shadow_branch"} if name == "grass" else set())
    assert set(sites) <= allowed, sites


# -- the shadow query kernel (kernels/shadow_query.py) ------------------------

SHADOW_BOUNDS = ([-0.5, -0.5, -0.2], [0.5, 0.5, 0.6])


def _shadow_scene(rs, n_box, n_tri, m):
    """Boxes turned about z and tilted a little over [-3, 3]^2 (instance 0
    the identity at the origin), triangles of every size over the same
    ground, and m points with directions toward a light above, as numpy."""
    ang = rs.uniform(0, 2 * np.pi, n_box)
    tilt = rs.normal(0, 0.1, (n_box, 3, 3))
    rot = np.zeros((n_box, 3, 3))
    rot[:, 0, 0], rot[:, 0, 1], rot[:, 1, 0], rot[:, 1, 1] = (np.cos(ang), np.sin(ang),
                                                              -np.sin(ang), np.cos(ang))
    rot[:, 2, 2] = 1
    rot = (rot + tilt) / rs.uniform(0.5, 1.5, (n_box, 1, 1))
    origin = np.concatenate([rs.uniform(-3, 3, (n_box, 2)), rs.uniform(-0.3, 0.3, (n_box, 1))], 1)
    rot[0], origin[0] = np.eye(3), 0
    trans = -np.einsum("nij,nj->ni", rot, origin)
    v0 = np.concatenate([rs.uniform(-3, 3, (n_tri, 2)), rs.uniform(-0.5, 1.5, (n_tri, 1))], 1)
    e1 = rs.normal(0, 1, (n_tri, 3)) * rs.uniform(0.01, 1, (n_tri, 1))
    e2 = rs.normal(0, 1, (n_tri, 3)) * rs.uniform(0.01, 1, (n_tri, 1))
    pts = np.concatenate([rs.uniform(-3, 3, (m, 2)), rs.uniform(-0.4, 1.0, (m, 1))], 1)
    light = rs.normal(0, 0.5, (m, 3)) + [0, 0, 1]
    return rot, trans, (v0, e1, e2), pts, light


def _shadow_args(device, rot, trans, tri, pts, light, inst_sel=None, tri_sel=None):
    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    tris = None
    if tri is not None:
        v0, e1, e2 = (f32(x) for x in tri)
        tris = (v0, e1, e2, torch.linalg.cross(e1, e2))

    def sel(s):
        if s is None:
            return None
        ids, valid = s
        return (torch.tensor(ids, dtype=torch.int64, device=device),
                torch.tensor(valid, dtype=torch.bool, device=device))

    return (f32(pts), f32(light), (f32(rot), f32(trans)), tris,
            tuple(f32(b) for b in SHADOW_BOUNDS), sel(inst_sel), sel(tri_sel))


def _candidates(rs, n, c):
    """c candidate ids of n, ascending, the last quarter padding (id 0,
    invalid), as _keep_to_candidates lays them out."""
    k = c - c // 4
    ids = np.concatenate([np.sort(rs.choice(n, k, replace=False)), np.zeros(c - k, np.int64)])
    return ids, np.arange(c) < k


def _shadow_case(name, device):
    """(query arguments, the share of blocked points the case must show: a
    (low, high) range) of one named case; m = 4099 points (not a multiple
    of any CTA size) unless the case needs fewer."""
    rs = np.random.RandomState(sorted(SHADOW_CASES).index(name))
    rot, trans, tri, pts, light = _shadow_scene(rs, 300, 700, 4099)
    b0, b1 = SHADOW_BOUNDS
    if name == "full":
        return _shadow_args(device, rot, trans, tri, pts, light), (0.3, 0.9)
    if name == "culled_with_padding":
        return _shadow_args(device, rot, trans, tri, pts, light, _candidates(rs, 300, 128),
                            _candidates(rs, 700, 256)), (0.1, 0.6)
    if name == "no_triangles":
        return _shadow_args(device, rot, trans, None, pts, light), (0.1, 0.6)
    if name == "no_boxes":
        return _shadow_args(device, rot[:0], trans[:0], tri, pts, light), (0.3, 0.9)
    if name == "face_planes":
        # Points on the identity box's face planes and edges, lit straight
        # up, along the axes and slanted: t = 0, crossings at the bounds.
        xy = rs.choice([b0[0], b1[0], b0[1], b1[1], 0.0, 0.25], (4099, 2))
        z = rs.choice([b0[2], b1[2], b0[2] - 0.1, b1[2] + 0.1, 0.0], (4099, 1))
        dirs = np.array([[0, 0, 1], [0, 0, -1], [1, 0, 1], [0, -1, 1], [1, 1, -1], [1, 0, 0]])
        light = dirs[rs.randint(0, len(dirs), 4099)]
        return _shadow_args(device, rot, trans, tri, np.concatenate([xy, z], 1), light), (
            0.5, 0.99)
    if name == "dz_near_the_floor":
        # Light directions whose local dz in box 0 (the identity) lies at
        # and around 1e-12 (float32's nearest), either sign, 0 and denormal;
        # 29 other boxes block some of the points.
        eps = np.float32(1e-12)
        zs = np.array([eps, np.nextafter(eps, np.float32(1)), np.nextafter(eps, np.float32(0)),
                       -eps, -np.nextafter(eps, np.float32(1)), 0.0, 1e-13, 1e-11, 1e-40],
                      np.float32)
        light = np.concatenate([rs.uniform(-1, 1, (4099, 2)), rs.choice(zs, (4099, 1))], 1)
        pts = np.concatenate([rs.uniform(-0.6, 0.6, (4099, 2)), rs.choice(
            [b0[2], b1[2], 0.0, -0.3, 0.7], (4099, 1))], 1)
        return _shadow_args(device, rot[:30], trans[:30], None, pts, light), (0.05, 0.95)
    if name == "det_near_the_floor":
        # Right triangles of legs a ~ 1e-6 in the xy plane, lit along z:
        # det = -+a^2 at and around 1e-12.
        a = np.float32(1e-6) * (1 + rs.choice([0.0, 1e-7, -1e-7, 1e-3, -1e-3, 0.5], (700, 1)))
        v0 = np.concatenate([rs.uniform(-1e-6, 0, (700, 2)), rs.uniform(0.5, 1, (700, 1))], 1)
        e1 = np.concatenate([a, np.zeros((700, 2))], 1) * rs.choice([1, -1], (700, 1))
        e2 = np.concatenate([np.zeros((700, 1)), a, np.zeros((700, 1))], 1)
        pts = np.concatenate([rs.uniform(-1e-6, 1e-6, (4099, 2)), np.zeros((4099, 1))], 1)
        light = np.tile([0.0, 0.0, 1.0], (4099, 1))
        return _shadow_args(device, rot[:0], trans[:0], (v0, e1, e2), pts, light), (0.2, 0.8)
    if name == "every_point_blocked":
        # One sheet over the whole ground, its front face toward the points.
        sheet = (np.array([[-100, -100, 10.0]]), np.array([[0, 400, 0.0]]),
                 np.array([[400, 0, 0.0]]))
        light = np.tile([0.0, 0.0, 1.0], (4099, 1)) + rs.normal(0, 0.01, (4099, 3))
        return _shadow_args(device, rot, trans, sheet, pts, light), (1.0, 1.0)
    if name == "no_point_blocked":
        # Every point above everything, lit from above.
        pts = pts + [0, 0, 20.0]
        light[:, 2] = np.abs(light[:, 2]) + 0.1
        return _shadow_args(device, rot, trans, tri, pts, light), (0.0, 0.0)
    if name == "one_point":
        return _shadow_args(device, rot, trans, tri, pts[:1], light[:1]), (0.0, 1.0)
    raise KeyError(name)


SHADOW_CASES = ("full", "culled_with_padding", "no_triangles", "no_boxes", "face_planes",
                "dz_near_the_floor", "det_near_the_floor", "every_point_blocked",
                "no_point_blocked", "one_point")


@pytest.mark.parametrize("name", SHADOW_CASES)
def test_shadow_query_kernel_is_bit_equal_to_plain(cuda, name):
    from nerftex_torch.kernels import shadow_query as sq

    args, (low, high) = _shadow_case(name, cuda)
    before = sq.shadow_query.launches
    got = sq.shadow_query(*args)
    torch.cuda.synchronize()
    assert sq.shadow_query.launches == before + 1
    assert got.dtype == torch.bool and got.shape == args[0].shape[:1]
    assert torch.equal(got, sq.shadow_query_plain(*args))
    share = got.float().mean().item()
    assert low <= share <= high, (name, share)


def test_shadow_query_kernel_refuses_bad_inputs(cuda):
    from nerftex_torch.kernels import shadow_query as sq

    args = list(_shadow_case("full", cuda)[0])
    before = sq.shadow_query.launches
    with pytest.raises(TypeError):
        sq.shadow_query(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        sq.shadow_query(args[0], args[1][:-1], *args[2:])
    with pytest.raises(ValueError):
        sq.shadow_query(args[0].T.contiguous().T, *args[1:])
    with pytest.raises(ValueError):
        sq.shadow_query(args[0], args[1].cpu(), *args[2:])
    assert sq.shadow_query.launches == before


def test_grass_frame_answers_every_shadow_point_in_the_kernel(cuda, tmp_path):
    """A 64x64 frame of configs/config_grass_render.py through RenderSession
    at the grass operating point (f32 MLP, random weights), recorded: every
    point that entered the shadow query was answered by the kernel."""
    import importlib
    import os

    from nerftex_torch import operating_points
    from nerftex_torch.kernels import shadow_query as sq
    from nerftex_torch.render.serve import RenderSession
    from nerftex_torch.utils import trace

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = dict(importlib.import_module("configs.config_grass_render").config,
               target_path=str(tmp_path))
    cfg["renderer_config"] = dict(cfg["renderer_config"])
    inst = cfg["renderer_config"]["instancer_config"] = dict(
        cfg["renderer_config"]["instancer_config"])
    for k in ("mesh_path", "patch_origins_path"):
        inst[k] = os.path.join(root, inst[k])
    point = dict(operating_points.resolve("grass"), compute_dtype="float32")
    session = RenderSession(cfg, height=64, width=64, operating_point=point)
    before = sq.shadow_query.launches
    trace.reset()
    with trace.recording():
        img = session.render([0.30614675, -0.73910363, 0.6], [0, 0.33, 0.47, -0.64, 0.6])
    totals = trace.totals()
    trace.reset()
    assert img.shape == (64, 64, 4) and np.isfinite(img).all()
    assert sq.shadow_query.launches > before
    assert totals["shadow.points"] > 0
    assert totals["shadow.kernel"] == totals["shadow.points"]


# -- the per-ray kernels (kernels/per_ray.py) ----------------------------------



@pytest.fixture(scope="module")
def per_ray_frames():
    """chip_smoke.per_ray_setup of each scene (instancer, rays, parameters,
    S, step), built once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    return {name: chip_smoke.per_ray_setup(name) for name in chip_smoke.PER_RAY_SCENES}


@pytest.mark.parametrize("culled", [True, False], ids=["culled", "full"])
@pytest.mark.parametrize("name", ["carpet", "grass", "plush"])
def test_per_ray_kernel_matches_plain(per_ray_frames, name, culled):
    """The kernels against the plain chain on three blocks of the frame (an
    eighth in from each end and the middle; carpet's middle blocks overrun
    its budgets):
    discrete outputs equal but on knife-edge rays (listed), floats within
    chip_smoke.PER_RAY_FLOAT_TOL of their scale; culled, every fitting
    keep set holds every column the block's rays hit, and one fits."""
    import chip_smoke as cs
    from nerftex_torch.kernels import per_ray as pr

    dev, rays_o, rays_d, _, S, step = per_ray_frames[name]
    rb = dev.ray_block
    n = rays_o.shape[0] // rb
    knife, fitting = [], 0
    for b in (n // 8, n // 2, n - 1 - n // 8):
        sl = slice(b * rb, (b + 1) * rb)
        args = cs.per_ray_args(dev, rays_o[sl], rays_d[sl], S, step, culled)
        before = pr.per_ray.launches
        got = pr.per_ray(*args)
        torch.cuda.synchronize()
        assert pr.per_ray.launches == before + 1
        assert (got["cull"] is not None) == culled
        edges, _ = cs.compare_per_ray(args, got, pr.per_ray_plain(*args))
        knife += [b * rb + r for r in edges]
        if culled:
            fitting += sum(v[2] is not None for v in cs.per_ray_keep_sets(args, got).values())
    print(f"per_ray {name} {'culled' if culled else 'full'}: knife-edge rays {knife}")
    assert not culled or fitting > 0


def _per_ray_scene(rs, device, n_box=300, n_tri=400, thin=False, dup=0):
    """A DeviceScene-like scene: boxes turned about z over [-3, 3]^2 at
    scales 0.5-1.5 (the last ``dup`` copies of the first ones), triangles
    of every size over the same ground, with the bounding spheres the
    culls test."""
    import types

    from nerftex_torch.instancing.geometry import slab_kappa

    b_0 = np.array([-0.5, -0.5, -0.2], np.float32)
    b_1 = np.array([0.5, 0.5, -0.2 + 1e-3 if thin else 0.6], np.float32)
    ang = rs.uniform(0, 2 * np.pi, n_box)
    scale = rs.uniform(0.5, 1.5, n_box)
    pos = np.stack([rs.uniform(-3, 3, n_box), rs.uniform(-3, 3, n_box),
                    rs.uniform(0, 0.5, n_box)], 1)
    if dup:
        ang[-dup:], scale[-dup:], pos[-dup:] = ang[:dup], scale[:dup], pos[:dup]
    c, s = np.cos(ang), np.sin(ang)
    rot = np.zeros((n_box, 3, 3))
    rot[:, 0, 0], rot[:, 0, 1], rot[:, 1, 0], rot[:, 1, 1], rot[:, 2, 2] = c, -s, s, c, 1
    fwd = rot * scale[:, None, None]
    inv = np.transpose(rot, (0, 2, 1)) / scale[:, None, None]
    mid, half = (b_0 + b_1) / 2, (b_1 - b_0) / 2
    t = lambda x: torch.tensor(np.ascontiguousarray(x, np.float32), device=device)  # noqa: E731
    scene = types.SimpleNamespace(
        n_instances=n_box, inv_rot=t(inv), inv_trans=t(-np.einsum("nij,nj->ni", inv, pos)),
        origins=t(pos), inst_center=t(pos + np.einsum("nij,j->ni", fwd, mid)),
        inst_radius=t(scale * np.linalg.norm(half)), b_0=t(b_0), b_1=t(b_1), n_tris=n_tri,
        slab_kappa=slab_kappa(inv.astype(np.float32)))
    if n_tri:
        v0 = np.concatenate([rs.uniform(-4, 4, (n_tri, 2)), rs.uniform(-0.2, 0.3, (n_tri, 1))], 1)
        e1, e2 = rs.normal(0, 0.4, (n_tri, 3)), rs.normal(0, 0.4, (n_tri, 3))
        cen = v0 + (e1 + e2) / 3
        rad = np.max([np.linalg.norm(cen - p, axis=1) for p in (v0, v0 + e1, v0 + e2)], 0)
        scene.tri_v0, scene.tri_e1, scene.tri_e2 = t(v0), t(e1), t(e2)
        scene.tri_center, scene.tri_radius = t(cen), t(rad)
    return scene


def _per_ray_rays(rs, m, up=False, spread=2.0):
    """m rays from above the ground toward it (``up``: away from it), at
    targets within ``spread`` of the middle."""
    o = np.stack([rs.uniform(-1, 1, m), rs.uniform(-6, -5, m), rs.uniform(2.5, 3.5, m)], 1)
    target = np.stack([rs.uniform(-spread, spread, m), rs.uniform(-spread, spread, m),
                       rs.uniform(0, 0.3, m)], 1)
    d = target - o
    if up:
        d[:, 2] = np.abs(d[:, 2])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _per_ray_case(name, device):
    """(kernels.per_ray's arguments, a check of the result) of one named
    case; 1,001 rays (not a multiple of a CTA's rays) unless it needs
    others."""
    rs = np.random.RandomState(sorted(PER_RAY_CASES).index(name) + 11)
    scene = _per_ray_scene(rs, device, thin=name == "tiny_intervals",
                           dup=100 if name == "equal_t0" else 0,
                           n_tri=0 if name == "no_triangles" else 400)
    o, d = _per_ray_rays(rs, 1001, up=name == "no_kept_column",
                         spread=0.3 if name in ("culled", "bfloat16") else 2.0)
    K, S, step, budgets, prec = 48, 320, 0.002, (128, 96), "float32"
    check = None
    if name == "no_triangles":
        def check(got):
            return got["tri"] is None and not torch.isfinite(got["t_mesh"]).any()
    elif name == "no_kept_column":
        o[:, 2] += 5.0

        def check(got):
            cull = got["cull"].cpu().tolist()
            return cull[:4] == [0, 0, 2, 0] and not got["hit"].any()
    elif name == "over_both_budgets":
        budgets = (48, 8)
        d = rs.normal(0, 1, (1001, 3))
        d[:, 2] = -np.abs(d[:, 2])
        d /= np.linalg.norm(d, axis=1, keepdims=True)

        def check(got):
            return got["cull"][2:4].cpu().tolist() == [0, 2]
    elif name == "tiny_directions":
        # Directions straight down with x, y components at and around
        # 1e-12 (float32's nearest), either sign, 0 and denormal: the local
        # d_x, d_y hit the slab test's floor.
        eps = np.float32(1e-12)
        comp = np.array([eps, np.nextafter(eps, np.float32(1)), np.nextafter(eps, np.float32(0)),
                         -eps, 0.0, 1e-13, 1e-40], np.float32)
        d = np.concatenate([rs.choice(comp, (1001, 2)), -np.ones((1001, 1))], 1)
        o = np.concatenate([rs.uniform(-3, 3, (1001, 2)), np.full((1001, 1), 3.0)], 1)
        scene.inv_rot[:] = torch.eye(3, device=device)
        scene.inv_trans[:] = -scene.origins
        scene.inst_center = scene.origins + (scene.b_0 + scene.b_1) / 2
        scene.inst_radius[:] = float(torch.linalg.norm(scene.b_1 - scene.b_0)) / 2
    elif name == "equal_t0":
        # 100 boxes twice over, and half the rays starting inside box 0:
        # equal t0 across columns (t0c = 0 inside), broken by column.
        o[:500] = scene.origins[0].cpu().numpy() + [0.05, 0.0, 0.1]

        def check(got):
            tk0 = got["tk0"]
            return bool(((tk0[:, 1:] == tk0[:, :-1]) & got["kvalid"][:, 1:]).any())
    elif name == "more_than_k":
        # Level rays through the boxes, 8 slots.
        K = 8
        o[:, 2] = 0.3
        d[:, 2] = 0.0
        d /= np.linalg.norm(d, axis=1, keepdims=True)

        def check(got):
            return int(got["overflow_hits"]) > 0
    elif name == "tiny_intervals":
        step = 0.05

        def check(got):
            return bool(got["tiny"].any())
    elif name == "bfloat16":
        # The narrow fan of "culled" with bfloat16 slab operands: both keep
        # sets fit, the instance spheres widened by geometry.slab_pad.
        prec = "bfloat16"
        o[:] = o[0]
        budgets = (256, 192)

        def check(got):
            return got["cull"][2:4].cpu().tolist() == [2, 0]
    elif name == "strided_rays":
        # One origin as a pose's column, expanded over the block (strides
        # (0, 4)), and directions stored column-major (strides (1, m)).
        o[:] = o[0]
    elif name == "culled":
        # One camera, a narrow fan: both keep sets fit.
        o[:] = o[0]
        budgets = (256, 192)

        def check(got):
            return got["cull"][2:4].cpu().tolist() == [2, 0]
    else:
        raise KeyError(name)
    t = lambda x: torch.tensor(np.asarray(x, np.float32), device=device)  # noqa: E731
    u_off = t(rs.uniform(0, 1, o.shape[0]))
    rays_o, rays_d = t(o), t(d)
    if name == "strided_rays":
        pose = torch.eye(4, device=device)
        pose[:3, 3] = rays_o[0]
        rays_o, rays_d = pose[:3, 3].expand(o.shape[0], 3), rays_d.T.contiguous().T
    return (scene, rays_o, rays_d, u_off, K, S, step, *budgets, prec), check


PER_RAY_CASES = ("culled", "no_triangles", "no_kept_column", "over_both_budgets",
                 "tiny_directions", "equal_t0", "more_than_k", "tiny_intervals", "bfloat16",
                 "strided_rays")


@pytest.mark.parametrize("name", PER_RAY_CASES)
def test_per_ray_kernel_edge_cases_match_plain(cuda, name):
    """The kernels against the plain chain on synthetic blocks, each case
    with its own check that the edge it names was reached."""
    import chip_smoke as cs
    from nerftex_torch.kernels import per_ray as pr

    args, check = _per_ray_case(name, cuda)
    got = pr.per_ray(*args)
    torch.cuda.synchronize()
    edges, _ = cs.compare_per_ray(args, got, pr.per_ray_plain(*args))
    print(f"per_ray {name}: knife-edge rays {edges}")
    cs.per_ray_keep_sets(args, got)
    assert check is None or check(got), name


def test_per_ray_kernel_refuses_bad_inputs(cuda):
    from nerftex_torch.kernels import per_ray as pr

    args = list(_per_ray_case("culled", cuda)[0])
    before = pr.per_ray.launches
    with pytest.raises(TypeError):
        pr.per_ray(args[0], args[1].double(), *args[2:])
    with pytest.raises(ValueError):
        pr.per_ray(args[0], args[1], args[2][:-1], *args[3:])
    with pytest.raises(ValueError):
        pr.per_ray(*args[:3], torch.stack([args[3], args[3]], 1)[:, 0], *args[4:])
    with pytest.raises(ValueError):
        pr.per_ray(*args[:4], pr.MAX_HITS + 1, *args[5:])
    with pytest.raises(ValueError):
        pr.per_ray(args[0], args[1], args[2], args[3].cpu(), *args[4:])
    assert pr.per_ray.launches == before
