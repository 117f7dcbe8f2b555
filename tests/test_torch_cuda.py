"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc (the kernels build on first
use) and skips without one; run them with
``python -m pytest tests/test_torch_cuda.py -m cuda``. Inputs are seeded
numpy draws; tolerance atol 1e-5 relative to max(1, |output|) (fp32 sums in
another order), 1e-4 for the flow at MMS width (as its JAX test). The plain
versions are pinned against the JAX package by ``tests/test_torch_kernels.py``
and ``tests/test_torch_flow_kernel.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vits_tpu_torch.ops.cuda.attention import flash_rel_attention, rel_attention_reference
from vits_tpu_torch.ops.cuda.resblock import fused_resblock_trio, resblock_trio_reference
from vits_tpu_torch.ops.cuda.stage import fused_stage, stage_reference

SLOPE = 0.1
ATOL = 1e-5


def _masked(rng, B, T, C, lengths):
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    return x * (np.arange(T)[None, :] < np.asarray(lengths)[:, None])[..., None]


def _blocks(rng, C, ks=(3, 7, 11), scale=0.05):
    return [dict(
        kernel_size=k, dilations=(1, 3, 5),
        w1=(rng.standard_normal((3, k, C, C)) * scale).astype(np.float32),
        b1=(rng.standard_normal((3, C)) * scale).astype(np.float32),
        w2=(rng.standard_normal((3, k, C, C)) * scale).astype(np.float32),
        b2=(rng.standard_normal((3, C)) * scale).astype(np.float32),
    ) for k in ks]


def _to(blocks, convert):
    return [{k: (convert(v) if isinstance(v, np.ndarray) else v) for k, v in b.items()}
            for b in blocks]


def _assert_close(got, want, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0)



@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (vits_tpu_torch CUDA kernels)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_trio_kernel_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(1)
    lengths = [160, 71]
    x = torch.tensor(_masked(rng, 2, 160, 256, lengths), device=cuda_device)
    blocks = _to(_blocks(rng, 256, scale=0.03), lambda a: torch.tensor(a, device=cuda_device))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    before = fused_resblock_trio.launches
    got = fused_resblock_trio(x, blocks, slope=SLOPE, lengths=lens)
    assert fused_resblock_trio.launches == before + 1
    _assert_close(got.cpu(), resblock_trio_reference(x, blocks, slope=SLOPE, lengths=lens).cpu())


@pytest.mark.cuda
def test_stage_kernel_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(2)
    lengths = [96, 40]
    x = torch.tensor(_masked(rng, 2, 96, 64, lengths), device=cuda_device)
    dev = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda_device)  # noqa: E731
    up_w, up_b = dev(rng.standard_normal((4, 64, 32)) * 0.1), dev(rng.standard_normal(32) * 0.1)
    blocks = _to(_blocks(rng, 32, scale=0.1), dev)
    kw = dict(stride=2, up_padding=1, slope=SLOPE,
              lengths=torch.tensor(lengths, dtype=torch.int32, device=cuda_device),
              final_conv=(dev(rng.standard_normal((7, 32, 1)) * 0.3), 3))
    before = fused_stage.launches
    got = fused_stage(x, up_w, up_b, blocks, **kw)
    assert fused_stage.launches == before + 1
    _assert_close(got.cpu(), stage_reference(x, up_w, up_b, blocks, **kw).cpu())


@pytest.mark.cuda
def test_attention_kernel_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(3)
    B, H, L, d, w = 3, 2, 77, 96, 4
    dev = lambda *s: torch.tensor(  # noqa: E731
        rng.standard_normal(s) * 0.5, dtype=torch.float32, device=cuda_device)
    q, k, v, rel_k, rel_v = dev(B, H, L, d), dev(B, H, L, d), dev(B, H, L, d), \
        dev(2 * w + 1, d), dev(2 * w + 1, d)
    lens = torch.tensor([77, 0, 30], dtype=torch.int32, device=cuda_device)
    got = flash_rel_attention(q, k, v, rel_k, rel_v, window=w, lengths=lens)
    assert bool(torch.isfinite(got).all())
    _assert_close(got.cpu(), rel_attention_reference(q, k, v, rel_k, rel_v, window=w,
                                                     lengths=lens).cpu())


@pytest.mark.cuda
def test_attention_lse_and_backward_match_plain_on_card(cuda_device):
    """Kernel A's lse and kernel 4's five gradients vs the plain versions, valid region."""
    from vits_tpu_torch.ops.cuda.attention_grad import (
        rel_attention_bwd,
        rel_attention_bwd_reference,
    )

    rng = np.random.default_rng(4)
    B, H, L, d, w = 3, 2, 77, 96, 4
    dev = lambda *s: torch.tensor(  # noqa: E731
        rng.standard_normal(s) * 0.5, dtype=torch.float32, device=cuda_device)
    q, k, v, dout = (dev(B, H, L, d) for _ in range(4))
    rel_k, rel_v = dev(2 * w + 1, d), dev(2 * w + 1, d)
    lengths = [77, 0, 30]
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    before = flash_rel_attention.lse_launches
    out, lse = flash_rel_attention(q, k, v, rel_k, rel_v, window=w, lengths=lens,
                                   return_lse=True)
    assert flash_rel_attention.lse_launches == before + 1
    _, want_lse = rel_attention_reference(q, k, v, rel_k, rel_v, window=w, lengths=lens,
                                          return_lse=True)
    assert bool(torch.isfinite(lse).all())
    for b in range(B):  # per row: the length-0 row's lse is near finfo.min
        _assert_close(lse[b].cpu(), want_lse[b].cpu())
    before = rel_attention_bwd.launches
    got = rel_attention_bwd(q, k, v, rel_k, rel_v, lse, dout, out, window=w, lengths=lens)
    assert rel_attention_bwd.launches == before + 1
    want = rel_attention_bwd_reference(q, k, v, rel_k, rel_v, lse, dout, out, window=w,
                                       lengths=lens)
    for g, ref in zip(got[:3], want[:3]):
        for b, n in enumerate(lengths):
            if n:
                _assert_close(g[b, :, :n].cpu(), ref[b, :, :n].cpu())
    for g, ref in zip(got[3:], want[3:]):
        _assert_close(g.cpu(), ref.cpu())
    again = rel_attention_bwd(q, k, v, rel_k, rel_v, lse, dout, out, window=w, lengths=lens)
    for g, g2 in zip(got, again):  # no atomics: repeated runs are bit-identical
        assert torch.equal(g, g2)


@pytest.mark.cuda
def test_trainable_trio_matches_plain_on_card(cuda_device):
    """Kernel 5's output, saved activations and autograd gradients vs the plain versions."""
    from vits_tpu_torch.ops.cuda.trio_grad import (
        trainable_trio,
        trio_forward_with_acts,
        trio_forward_with_acts_reference,
    )

    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((2, 100, 128)), dtype=torch.float32,
                     device=cuda_device)
    blocks = _to(_blocks(rng, 128, scale=0.03),
                 lambda a: torch.tensor(a, device=cuda_device, requires_grad=True))
    with torch.no_grad():
        out, acts = trio_forward_with_acts(x, blocks, slope=SLOPE)
        want, want_acts = trio_forward_with_acts_reference(x, blocks, slope=SLOPE)
    _assert_close(out.cpu(), want.cpu())
    for (y1s, xs), (wy1s, wxs) in zip(acts, want_acts):
        for a, b in zip([*y1s, *xs], [*wy1s, *wxs]):
            _assert_close(a.cpu(), b.cpu())
    g = torch.tensor(rng.standard_normal((2, 100, 128)), dtype=torch.float32,
                     device=cuda_device)
    xg = x.clone().requires_grad_()
    leaves = [xg] + [blk[n] for blk in blocks for n in ("w1", "b1", "w2", "b2")]
    before = trio_forward_with_acts.launches
    got = torch.autograd.grad((trainable_trio(xg, blocks, slope=SLOPE) * g).sum(), leaves)
    assert trio_forward_with_acts.launches == before + 1
    ref = torch.autograd.grad((resblock_trio_reference(xg, blocks, slope=SLOPE) * g).sum(),
                              leaves)
    for a, b in zip(got, ref):
        _assert_close(a.cpu(), b.cpu())


@pytest.mark.cuda
def test_inference_kernels_refuse_autograd(cuda_device):
    """Kernels A (without lse), B and C have no backward: under autograd they raise."""
    rng = np.random.default_rng(6)
    dev = lambda *s: torch.tensor(  # noqa: E731
        rng.standard_normal(s) * 0.1, dtype=torch.float32, device=cuda_device)
    q, rel = dev(1, 2, 16, 32).requires_grad_(), dev(9, 32)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_rel_attention(q, q, q, rel, rel, window=4)
    blocks = _to(_blocks(rng, 128), lambda a: torch.tensor(a, device=cuda_device))
    x = dev(1, 32, 128).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        fused_resblock_trio(x, blocks, slope=SLOPE)
    up_w, up_b = dev(4, 64, 32).requires_grad_(), dev(32)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_stage(dev(1, 16, 64), up_w, up_b, _to(_blocks(rng, 32), lambda a: torch.tensor(
            a, device=cuda_device)), stride=2, up_padding=1, slope=SLOPE)
    with torch.no_grad():  # the serving path: no autograd, the kernels run
        assert fused_resblock_trio(x, blocks, slope=SLOPE).shape == x.shape


@pytest.fixture(scope="module")
def vctk_flow():
    """Flow weights of a multi-speaker model at VCTK/MMS width (flow 192, hidden 192, 4x4)."""
    from vits_tpu_torch.config import VitsConfig
    from vits_tpu_torch.io import random_params

    if not torch.cuda.is_available():  # a module fixture is set up before cuda_device skips
        pytest.skip("needs an NVIDIA GPU and nvcc (vits_tpu_torch CUDA kernels)")
    config = VitsConfig(num_speakers=109, speaker_embedding_size=256)
    params = random_params(config, seed=0, keep_training=False)
    return config, {k: v for k, v in params.items() if k.startswith("flow.")}


@pytest.mark.cuda
@pytest.mark.parametrize("speaker", [False, True])
def test_flow_kernel_matches_plain_on_card(cuda_device, vctk_flow, speaker):
    """Kernel 6 with a length-0 row, with and without speaker conditioning."""
    from vits_tpu_torch.io.params import ParamView, from_jax_params
    from vits_tpu_torch.ops.cuda.flow import flow_reference, fused_flow

    config, params = vctk_flow
    p = ParamView(from_jax_params(params, cuda_device))
    rng = np.random.default_rng(7)
    lengths = [150, 0, 61]
    x = torch.tensor(_masked(rng, 3, 150, config.flow_size, lengths), device=cuda_device)
    emb = None
    if speaker:
        emb = torch.tensor(rng.standard_normal((3, 1, config.speaker_embedding_size)) * 0.3,
                           dtype=torch.float32, device=cuda_device)
    kw = dict(lengths=torch.tensor(lengths, dtype=torch.int32, device=cuda_device),
              speaker_embeddings=emb)
    before = fused_flow.launches
    got = fused_flow(x, p, config, **kw)
    assert fused_flow.launches == before + 1
    assert float(got[1].abs().max()) == 0.0 and float(got[2, 61:].abs().max()) == 0.0
    _assert_close(got.cpu(), flow_reference(x, p, config, **kw).cpu(), atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [8, 16, 32, 64])
def test_resblock_kernel_matches_plain_on_card(cuda_device, C):
    """Kernel 7 (one resblock) at the narrow stage widths, with a length-0 row."""
    from vits_tpu_torch.ops.cuda.resblock import fused_resblock, resblock_reference

    rng = np.random.default_rng(C)
    lengths = [300, 0, 123]
    x = torch.tensor(_masked(rng, 3, 300, C, lengths), device=cuda_device)
    block = _to(_blocks(rng, C, ks=(11,), scale=0.1),
                lambda a: torch.tensor(a, device=cuda_device))[0]
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    before = fused_resblock.launches
    got = fused_resblock(x, block, slope=SLOPE, lengths=lens)
    assert fused_resblock.launches == before + 1
    _assert_close(got.cpu(), resblock_reference(x, block, slope=SLOPE, lengths=lens).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("C_in,C_out,final", [(32, 16, False), (16, 8, True)])
def test_narrow_stage_kernel_matches_plain_on_card(cuda_device, C_in, C_out, final):
    """Kernel C at HiFi-GAN V2's tail widths, C_out 16 and 8 (+ conv_post)."""
    rng = np.random.default_rng(C_out)
    lengths = [200, 77]
    x = torch.tensor(_masked(rng, 2, 200, C_in, lengths), device=cuda_device)
    dev = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda_device)  # noqa: E731
    up_w = dev(rng.standard_normal((4, C_in, C_out)) * 0.2)
    up_b = dev(rng.standard_normal(C_out) * 0.1)
    blocks = _to(_blocks(rng, C_out, scale=0.1), dev)
    kw = dict(stride=2, up_padding=1, slope=SLOPE,
              lengths=torch.tensor(lengths, dtype=torch.int32, device=cuda_device),
              final_conv=(dev(rng.standard_normal((7, C_out, 1)) * 0.3), 3) if final else None)
    before = fused_stage.launches
    got = fused_stage(x, up_w, up_b, blocks, **kw)
    assert fused_stage.launches == before + 1
    _assert_close(got.cpu(), stage_reference(x, up_w, up_b, blocks, **kw).cpu())


@pytest.mark.cuda
def test_multispeaker_batch_rows_equal_solo_runs_on_card(cuda_device):
    """A narrow multi-speaker model through kernels A, 6, 7 and C: per-row speakers."""
    from vits_tpu_torch.config import EngineConfig, VitsConfig
    from vits_tpu_torch.engine.synthesizer import Synthesizer
    from vits_tpu_torch.io import VitsTokenizer, random_params
    from vits_tpu_torch.ops.cuda.flow import fused_flow
    from vits_tpu_torch.ops.cuda.resblock import fused_resblock

    config = dataclasses.replace(
        VitsConfig(), hidden_size=64, ffn_dim=128, num_hidden_layers=2, flow_size=32,
        upsample_initial_channel=64, num_speakers=4, speaker_embedding_size=16)
    vocab = "kzyuvdheswm' ablcfgijnopqrtx0123456789_-"
    tokenizer = VitsTokenizer(vocab={c: i for i, c in enumerate(vocab)}, pad_token="k",
                              unk_token="z")
    model = Synthesizer(config, tokenizer, random_params(config, seed=1, keep_training=False),
                        EngineConfig(use_pallas_flow=True), device=cuda_device)
    counts = {fn: fn.launches for fn in (fused_flow, fused_resblock, fused_stage)}
    texts, seeds, speakers = ["hello there", "good day to you all", "hi"], [1, 2, 3], [0, 3, 1]
    batch = model.synthesize_raw(texts, seed=seeds, speaker_id=speakers)
    assert all(fn.launches > n for fn, n in counts.items())
    for i, (text, seed, spk) in enumerate(zip(texts, seeds, speakers)):
        solo = model.synthesize_raw([text], seed=[seed], speaker_id=[spk])
        assert solo.frame_lengths[0] == batch.frame_lengths[i]
        n = solo.lengths[0]
        np.testing.assert_allclose(batch.waveform[i, :n], solo.waveform[0, :n], atol=2e-3,
                                   rtol=0)
