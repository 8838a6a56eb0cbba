"""The 2-D family's kernels and same-seed SDE samples on the card.

Imports nothing of JAX, so it runs where JAX is not installed, with
``python -m pytest --noconftest -m gpu tests/test_torch_unet2d_gpu.py``. Every
test is marked ``gpu`` and skips where there is no card:

* a UNet2D's 64² linear-attention block (4 heads × 32, bf16: 4096 tokens)
  launches K1 and K2 once each, its 32² full-attention block (1024 tokens) K3
  once, each within the forward tolerance of ``chip_smoke.py`` (3e-2 relative
  L2) of the same module in f32 on the CPU;
* the velocity SDE at 16³ b2 (the flagship's widths, seeded weights) gives
  bit-equal trajectories twice in a row from one seed, and the same decode
  without its trajectory; and again while a buffer holds all but 8 GiB of the
  card's free memory.
"""

import pytest
import torch

from flowtrain_stochastic_interpolation_torch.config import unconditional_64
from flowtrain_stochastic_interpolation_torch.inference import make_sampler
from flowtrain_stochastic_interpolation_torch.models.unet import UNet2D
from flowtrain_stochastic_interpolation_torch.ops import flash_attention as fa
from flowtrain_stochastic_interpolation_torch.ops import linear_attention as la
from flowtrain_stochastic_interpolation_torch.ops.embedding import simplex_embedding
from flowtrain_stochastic_interpolation_torch.train.loop import init_model_variables

FORWARD_REL_TOL = 3e-2
UNET2D = dict(dim=48, dim_mults=(1, 2, 4), data_channels=3, attn_heads=4, attn_dim_head=32,
              full_attn=(False, True, True))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _counts():
    return {**la.launch_counts, **fa.launch_counts}


@pytest.mark.gpu
@pytest.mark.parametrize("block,side,launched", [
    ("downs_0_attn", 64, {"folded_context": 1, "folded_project": 1}),
    ("downs_1_attn", 32, {"flash_attention": 1}),
])
def test_unet2d_attention_blocks_launch_their_kernels(cuda, block, side, launched):
    model = UNet2D(**UNET2D, dtype=torch.bfloat16, device=cuda)
    model.reset_parameters(torch.Generator(device=cuda).manual_seed(0))
    module = getattr(model, block)
    channels = module.norm.dim
    x = torch.randn(2, side, side, channels, generator=torch.Generator().manual_seed(1))
    reference = UNet2D(**UNET2D, device="cpu")
    reference.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    la.reset_launch_counts()
    fa.reset_launch_counts()
    with torch.inference_mode():
        got = module(x.to(cuda, torch.bfloat16)).float().cpu()
        want = getattr(reference, block)(x)
    assert _counts() == {name: launched.get(name, 0) for name in _counts()}
    assert torch.isfinite(got).all()
    assert ((got - want).norm() / want.norm()).item() < FORWARD_REL_TOL


@pytest.mark.gpu
def test_same_seed_sde_states_are_bit_equal(cuda):
    cfg = unconditional_64()
    model = init_model_variables(cfg, seed=0, device=cuda).eval()
    table = torch.from_numpy(simplex_embedding(cfg.data.num_categories,
                                               cfg.data.embedding_dim)).to(cuda)
    x0 = torch.randn(2, 16, 16, 16, cfg.data.embedding_dim,
                     generator=torch.Generator(device=cuda).manual_seed(2), device=cuda)

    def run(keep: bool) -> dict:
        sampler = make_sampler(model, table, n_frames=5, substeps=2, method="sde",
                               keep_trajectory=keep)
        return sampler(x0, generator=torch.Generator(device=cuda).manual_seed(3))

    la.reset_launch_counts()
    first = run(True)
    assert la.launch_counts["folded_context"] == 2 * 8  # 2 a forward, 8 evaluations
    assert torch.isfinite(first["trajectory"]).all()
    again = run(True)
    assert torch.equal(again["trajectory"], first["trajectory"])
    assert torch.equal(run(False)["decoded"], first["decoded"])
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info(cuda)
    held = torch.empty(max(free - 8 * 2**30, 0), dtype=torch.uint8, device=cuda)
    try:
        pressed, pressed_final = run(True), run(False)
    finally:
        del held
        torch.cuda.empty_cache()
    assert torch.equal(pressed["trajectory"], first["trajectory"])
    assert torch.equal(pressed_final["decoded"], first["decoded"])
