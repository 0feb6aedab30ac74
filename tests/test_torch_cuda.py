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
    rs = np.random.RandomState(0)
    for w, h in ((256, 256), (60, 40)):
        tex = torch.tensor(rs.rand(w, h).astype(np.float32), device=cuda)
        uv = torch.tensor(rs.uniform(-0.1, 1.1, (3, 1000, 2)).astype(np.float32), device=cuda)
        before = tex_gather.sample_channel.launches
        got = tex_gather.sample_channel(tex, uv)
        assert tex_gather.sample_channel.launches == before + 1
        # Both round every lerp operation separately: bit-equal.
        assert torch.equal(got, tex_gather.sample_channel_plain(tex, uv))


def test_tex_fetch_kernel_refuses_bad_inputs(cuda):
    tex = torch.rand(8, 8, device=cuda)
    with pytest.raises(TypeError):
        tex_gather.sample_channel(tex, torch.rand(5, 2, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        tex_gather.sample_channel(tex, torch.rand(2, 5, device=cuda).T)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_mlp_fused_kernel_matches_plain(cuda, dtype, tol):
    ff = {"module": "network.model.FourierFeatures", "n_freq_bands": 4}
    model = instantiate({"module": "network.model.ParamNerf", "pos_embedding": ff,
                         "dir_embedding": ff, "param_embedding": ff, "n_parameters": [1, 6],
                         "depth": 4, "width": 128, "skips": [1], "compute_dtype": dtype},
                        device=cuda)
    rs = np.random.RandomState(1)
    n = 1000                                   # not a multiple of the 64-row tile
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
