"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``: they skip where no GPU is present. On a machine with one
(and without JAX, which ``tests/conftest.py`` imports) run them with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from reazonspeech_tpu_torch.ops import (
    fused_conv_module, fused_conv_module_plain, launch_counts, relpos_attention_fused,
    relpos_attention_fused_plain, reset_launch_counts, topm_logsoftmax,
    topm_logsoftmax_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(gen, *shape, scale=1.0, dtype=torch.bfloat16, device="cuda"):
    return (torch.randn(shape, generator=gen) * scale).to(device=device, dtype=dtype)


@pytest.mark.parametrize("h,dh,t", [(8, 128, 376), (8, 128, 1000), (2, 64, 70), (8, 16, 33)])
def test_relpos_attention_kernel_matches_plain(dev, h, dh, t):
    """bf16 in and out: both round the probabilities to bf16 before p·v
    (the kernel before normalising, the twin after) and the output to bf16,
    so they agree to a few bf16 ulps (0.03 abs at |out| <= ~1). T=1000 is
    past the TPU kernel's cap (t_pad <= 512): the key loop has no cap."""
    gen = torch.Generator().manual_seed(t)
    b = 3
    q, k, v = (_rand(gen, b, t, h * dh, scale=0.5) for _ in range(3))
    pos = _rand(gen, 2 * t - 1, h, dh, scale=0.5)
    bu, bv = _rand(gen, h, dh, scale=0.1, dtype=torch.float32), _rand(
        gen, h, dh, scale=0.1, dtype=torch.float32)
    lengths = torch.tensor([t, max(t - 17, 1), 1], dtype=torch.int32, device=dev)
    got = relpos_attention_fused(q, k, v, pos, bu, bv, lengths, h)
    want = relpos_attention_fused_plain(q, k, v, pos, bu, bv, lengths, h)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() <= 0.03


@pytest.mark.parametrize("t,k", [(376, 9), (45, 3)])
def test_conv_module_kernel_matches_plain(dev, t, k):
    """bf16 in and out, fp32 inside: a few bf16 ulps (0.03 abs)."""
    gen = torch.Generator().manual_seed(k)
    b, d = 2, 256
    f32 = torch.float32
    x = _rand(gen, b, t, d)
    args = (x, torch.tensor([t, t // 2], dtype=torch.int32, device=dev),
            _rand(gen, d, 2 * d, scale=d ** -0.5, dtype=f32),
            _rand(gen, 2 * d, scale=0.1, dtype=f32),
            _rand(gen, k, 1, d, scale=k ** -0.5, dtype=f32), _rand(gen, d, scale=0.1, dtype=f32),
            1.0 + _rand(gen, d, scale=0.1, dtype=f32), _rand(gen, d, scale=0.1, dtype=f32),
            _rand(gen, d, d, scale=d ** -0.5, dtype=f32), _rand(gen, d, scale=0.1, dtype=f32))
    got = fused_conv_module(*args)
    want = fused_conv_module_plain(*args)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 0.03


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("integer", [False, True])
def test_topm_kernel_matches_plain(dev, dtype, integer):
    """Indices equal (ties to the lowest index), log-probs to 1e-4."""
    gen = torch.Generator().manual_seed(int(integer))
    x = torch.randn((16, 3001), generator=gen) * 3.0
    if integer:
        x = torch.randint(-3, 4, (16, 3001), generator=gen).float()
    x = x.to(device=dev, dtype=dtype)
    got = topm_logsoftmax(x, 4, 3000)
    want = topm_logsoftmax_plain(x, 4, 3000)
    torch.cuda.synchronize()
    assert torch.equal(got[2], want[2])
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=0)


def test_tiny_model_runs_the_kernels(dev):
    """The slice end to end on the card at a tiny width: every kernel runs."""
    from reazonspeech_tpu_torch.models.fastconformer import FastConformerConfig
    from reazonspeech_tpu_torch.models.rnnt import RNNTConfig
    from reazonspeech_tpu_torch.nemo.asr import audio_from_numpy, load_model, transcribe

    enc = FastConformerConfig.tiny(d_model=128, num_heads=8, attn_impl="pallas",
                                    conv_impl="pallas")
    model = load_model("cuda", checkpoint="random", enc_cfg=enc,
                       rnnt_cfg=RNNTConfig.tiny(enc_dim=128))
    wav = (np.random.default_rng(0).standard_normal(48000) * 0.1).astype(np.float32)
    reset_launch_counts()
    ret = transcribe(model, audio_from_numpy(wav, 16000))
    assert isinstance(ret.text, str)
    assert all(n > 0 for n in launch_counts().values()), launch_counts()
