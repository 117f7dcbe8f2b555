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

from vits_tpu_torch.ops.cuda import align as cuda_align
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
@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("C", [8, 16, 32, 64])
def test_resblock_kernel_matches_plain_on_card(cuda_device, C, k):
    """Kernel 7 (one resblock) at the narrow stage widths and k = 3, 7, 11, with a
    length-0 row, T = 300 a multiple of no time tile (block_plan's are multiples
    of 16) and a length ending mid-tile."""
    from vits_tpu_torch.ops.cuda.resblock import (
        block_plan,
        fused_resblock,
        resblock_reference,
    )

    rng = np.random.default_rng(C * 100 + k)
    lengths = [300, 0, 123]
    assert 300 % block_plan(3, 300, C, k, (1, 3, 5), torch.cuda.get_device_properties(
        cuda_device).multi_processor_count).bm
    x = torch.tensor(_masked(rng, 3, 300, C, lengths), device=cuda_device)
    block = _to(_blocks(rng, C, ks=(k,), scale=0.1),
                lambda a: torch.tensor(a, device=cuda_device))[0]
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    before = fused_resblock.launches
    got = fused_resblock(x, block, slope=SLOPE, lengths=lens)
    assert fused_resblock.launches == before + 1
    assert float(got[1].abs().max()) == 0.0 and float(got[2, 123:].abs().max()) == 0.0
    _assert_close(got.cpu(), resblock_reference(x, block, slope=SLOPE, lengths=lens).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("C", [32, 64])
def test_resblock_kernel_is_one_launch_and_repeats_bit_identical_on_card(cuda_device, C):
    """Kernel 7 at HiFi-GAN V2's stage 0 width: one call is one device launch (the
    profiler's kernel events), a second call gives the same bits, the
    accumulate path, (into + resblock(x)) * scale, matches the plain version,
    and so does a call without lengths (every row T long)."""
    from torch.profiler import ProfilerActivity, profile

    from vits_tpu_torch.ops.cuda.resblock import fused_resblock, resblock_reference

    rng = np.random.default_rng(C)
    lengths = [1000, 437]
    x = torch.tensor(_masked(rng, 2, 1000, C, lengths), device=cuda_device)
    block = _to(_blocks(rng, C, ks=(11,), scale=0.1),
                lambda a: torch.tensor(a, device=cuda_device))[0]
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    first = fused_resblock(x, block, slope=SLOPE, lengths=lens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = fused_resblock(x, block, slope=SLOPE, lengths=lens)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1, [e.name for e in kernels]
    assert torch.equal(first, again)
    want = resblock_reference(x, block, slope=SLOPE, lengths=lens)
    into = torch.tensor(_masked(rng, 2, 1000, C, lengths), device=cuda_device)
    expected = (into + want) * (1 / 3)
    got = fused_resblock(x, block, slope=SLOPE, lengths=lens, into=into, scale=1 / 3)
    assert got is into
    _assert_close(got.cpu(), expected.cpu())
    full = torch.tensor(rng.standard_normal((2, 1000, C)), dtype=torch.float32,
                        device=cuda_device)
    _assert_close(fused_resblock(full, block, slope=SLOPE).cpu(),
                  resblock_reference(full, block, slope=SLOPE).cpu())


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
    # the exact tier: the 2e-3 bound assumes fp32 (a batch's plans sum in other orders)
    model = Synthesizer(config, tokenizer, random_params(config, seed=1, keep_training=False),
                        EngineConfig(use_pallas_flow=True, **EngineConfig.fidelity_kwargs("exact")),
                        device=cuda_device)
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


@pytest.mark.cuda
def test_trio_kernel_split_path_matches_plain_on_card(cuda_device):
    """Kernel B at B=1, C=256 with T a multiple of no tile: a split-K cluster."""
    from vits_tpu_torch.ops.cuda import device_sm_count
    from vits_tpu_torch.ops.cuda.resblock import conv_plan

    T = 1000
    assert conv_plan(1, T, 256, 256, 3, device_sm_count(cuda_device)).split > 1
    rng = np.random.default_rng(8)
    x = torch.tensor(_masked(rng, 1, T, 256, [T - 37]), device=cuda_device)
    blocks = _to(_blocks(rng, 256, scale=0.03), lambda a: torch.tensor(a, device=cuda_device))
    lens = torch.tensor([T - 37], dtype=torch.int32, device=cuda_device)
    got = fused_resblock_trio(x, blocks, slope=SLOPE, lengths=lens)
    assert float(got[0, T - 37:].abs().max()) == 0.0
    _assert_close(got.cpu(), resblock_trio_reference(x, blocks, slope=SLOPE, lengths=lens).cpu())


@pytest.mark.cuda
def test_trio_forward_with_acts_at_training_shape_on_card(cuda_device):
    """Kernel 5's forward with its saved activations at B=4, T=256, C=256."""
    from vits_tpu_torch.ops.cuda.trio_grad import (
        flat_acts,
        trio_forward_with_acts,
        trio_forward_with_acts_reference,
    )

    rng = np.random.default_rng(9)
    x = torch.tensor(rng.standard_normal((4, 256, 256)), dtype=torch.float32, device=cuda_device)
    blocks = _to(_blocks(rng, 256, scale=0.03), lambda a: torch.tensor(a, device=cuda_device))
    with torch.no_grad():
        out, acts = trio_forward_with_acts(x, blocks, slope=SLOPE)
        want, want_acts = trio_forward_with_acts_reference(x, blocks, slope=SLOPE)
    _assert_close(out.cpu(), want.cpu())
    for a, b in zip(flat_acts(acts), flat_acts(want_acts)):
        _assert_close(a.cpu(), b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("C_in,C_out,final", [(128, 64, False), (64, 32, True)])
def test_stage_kernel_accumulate_paths_on_card(cuda_device, C_in, C_out, final):
    """Kernel C at C_out 64 and 32: the conv's residual and accumulate epilogues,
    with a length-0 row and a ragged one."""
    rng = np.random.default_rng(C_in)
    lengths = [700, 0, 333]
    x = torch.tensor(_masked(rng, 3, 700, C_in, lengths), device=cuda_device)
    dev = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda_device)  # noqa: E731
    # weights that keep the stage's activations O(1), so that the waveform's
    # atol is not spent on cuDNN's own fp32 error (1e-6 of the scale)
    up_w = dev(rng.standard_normal((4, C_in, C_out)) * 0.05)
    up_b = dev(rng.standard_normal(C_out) * 0.05)
    blocks = _to(_blocks(rng, C_out, scale=0.03), dev)
    kw = dict(stride=2, up_padding=1, slope=SLOPE,
              lengths=torch.tensor(lengths, dtype=torch.int32, device=cuda_device),
              final_conv=(dev(rng.standard_normal((7, C_out, 1)) * 0.1), 3) if final else None)
    got = fused_stage(x, up_w, up_b, blocks, **kw)
    assert float(got[1].abs().max()) == 0.0
    _assert_close(got.cpu(), stage_reference(x, up_w, up_b, blocks, **kw).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("with_lse", [False, True])
def test_attention_kernel_long_rows_on_card(cuda_device, with_lse):
    """Kernel A at B=3, L=512 with lengths (512, 200, 0): the loop that stops at a
    row's length, and the length-0 row's uniform weights, finite."""
    rng = np.random.default_rng(10)
    B, H, L, d, w = 3, 2, 512, 96, 4
    dev = lambda *s: torch.tensor(  # noqa: E731
        rng.standard_normal(s) * 0.5, dtype=torch.float32, device=cuda_device)
    q, k, v, rel_k, rel_v = dev(B, H, L, d), dev(B, H, L, d), dev(B, H, L, d), \
        dev(2 * w + 1, d), dev(2 * w + 1, d)
    lens = torch.tensor([512, 200, 0], dtype=torch.int32, device=cuda_device)
    got = flash_rel_attention(q, k, v, rel_k, rel_v, window=w, lengths=lens,
                              return_lse=with_lse)
    want = rel_attention_reference(q, k, v, rel_k, rel_v, window=w, lengths=lens,
                                   return_lse=with_lse)
    if with_lse:
        (got, lse), (want, want_lse) = got, want
        assert bool(torch.isfinite(lse).all())
        for b in range(B):
            _assert_close(lse[b].cpu(), want_lse[b].cpu())
    assert bool(torch.isfinite(got).all())
    _assert_close(got.cpu(), want.cpu())


@pytest.mark.cuda
def test_attention_backward_long_rows_on_card(cuda_device):
    """Kernel 4 at B=3, L=512, lengths (512, 200, 0) against its plain version: the
    key loop that stops at the length, the dk/dv tiles past it, the length-0 row's
    zeros; and a second run on the same inputs, bit-identical (no atomics)."""
    from vits_tpu_torch.ops.cuda.attention_grad import (
        rel_attention_bwd,
        rel_attention_bwd_reference,
    )

    rng = np.random.default_rng(11)
    B, H, L, d, w = 3, 2, 512, 96, 4
    dev = lambda *s: torch.tensor(  # noqa: E731
        rng.standard_normal(s) * 0.5, dtype=torch.float32, device=cuda_device)
    q, k, v, dout = (dev(B, H, L, d) for _ in range(4))
    rel_k, rel_v = dev(2 * w + 1, d), dev(2 * w + 1, d)
    lengths = [512, 200, 0]
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    out, lse = flash_rel_attention(q, k, v, rel_k, rel_v, window=w, lengths=lens,
                                   return_lse=True)
    args = (q, k, v, rel_k, rel_v, lse, dout, out)
    got = rel_attention_bwd(*args, window=w, lengths=lens)
    want = rel_attention_bwd_reference(*args, window=w, lengths=lens)
    for g, ref in zip(got[:3], want[:3]):
        for b, n in enumerate(lengths):
            if n:
                _assert_close(g[b, :, :n].cpu(), ref[b, :, :n].cpu())
            else:
                assert float(g[b].abs().max()) == 0.0
    for g in got[1:3]:  # dk, dv of keys past the length: exactly 0
        assert float(g[1, :, 200:].abs().max()) == 0.0
    for g, ref in zip(got[3:], want[3:]):
        _assert_close(g.cpu(), ref.cpu())
    again = rel_attention_bwd(*args, window=w, lengths=lens)
    for g, g2 in zip(got, again):
        assert torch.equal(g, g2)


@pytest.mark.cuda
def test_upsampler_unequal_phases_on_card(cuda_device):
    """Kernel C's polyphase upsampler at (stride, k, pad) = (4, 6, 1), 64 -> 16: the
    phases take 2, 1, 1 and 2 taps. The upsampler alone against conv_transpose1d,
    then the whole stage against its plain version; a length-0 row."""
    from vits_tpu_torch.ops.cuda import library, stream_of
    from vits_tpu_torch.ops.cuda.stage import polyphase_upsample

    rng = np.random.default_rng(12)
    lengths = [150, 0, 61]
    x = torch.tensor(_masked(rng, 3, 150, 64, lengths), device=cuda_device)
    dev = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda_device)  # noqa: E731
    up_w, up_b = dev(rng.standard_normal((6, 64, 16)) * 0.1), dev(rng.standard_normal(16) * 0.1)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    y = torch.empty((3, 600, 16), dtype=torch.float32, device=cuda_device)
    assert library().vk_upsample(x.data_ptr(), y.data_ptr(), up_w.data_ptr(), up_b.data_ptr(),
                                 lens.data_ptr(), 3, 150, 64, 16, 6, 4, 1, SLOPE, 0, 0, None,
                                 0, 0, 0, stream_of(x)) == 0
    want = polyphase_upsample(x.cpu(), up_w.cpu(), up_b.cpu(), stride=4, padding=1, slope=SLOPE,
                              lengths=lens.cpu())
    _assert_close(y.cpu(), want)
    assert float(y[1].abs().max()) == 0.0
    blocks = _to(_blocks(rng, 16, ks=(3, 7), scale=0.1), dev)
    kw = dict(stride=4, up_padding=1, slope=SLOPE, lengths=lens)
    got = fused_stage(x, up_w, up_b, blocks, **kw)
    _assert_close(got.cpu(), stage_reference(x, up_w, up_b, blocks, **kw).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("C", [8, 16])
def test_narrow_conv_accumulate_and_residual_on_card(cuda_device, C):
    """The narrow conv tile at C = 8 and 16 through three resblocks: the residual
    epilogue (each pair's second conv) and the accumulate/scale epilogue (the mean),
    with a length-0 row whose tiles skip their products."""
    rng = np.random.default_rng(20 + C)
    lengths = [300, 0, 123]
    x = torch.tensor(_masked(rng, 3, 300, C, lengths), device=cuda_device)
    blocks = _to(_blocks(rng, C, scale=0.1), lambda a: torch.tensor(a, device=cuda_device))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    before = fused_resblock_trio.launches
    got = fused_resblock_trio(x, blocks, slope=SLOPE, lengths=lens)
    assert fused_resblock_trio.launches == before + 1
    assert float(got[1].abs().max()) == 0.0 and float(got[2, 123:].abs().max()) == 0.0
    _assert_close(got.cpu(), resblock_trio_reference(x, blocks, slope=SLOPE, lengths=lens).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("speaker", [False, True])
def test_flow_kernel_three_rows_repeats_bit_identical_on_card(cuda_device, vctk_flow, speaker):
    """Kernel 6 at B=3, T=320, lengths (320, 137, 0): plain within 1e-4, packed once or
    on the call alike, a length-0 row exactly zero, and a repeated call bit-identical."""
    from vits_tpu_torch.io.params import ParamView, from_jax_params
    from vits_tpu_torch.ops.cuda.flow import flow_reference, fused_flow, pack_flow_weights

    config, params = vctk_flow
    p = ParamView(from_jax_params(params, cuda_device))
    rng = np.random.default_rng(11)
    T, lengths = 320, [320, 137, 0]
    x = torch.tensor(_masked(rng, 3, T, config.flow_size, lengths), device=cuda_device)
    emb = None
    if speaker:
        emb = torch.tensor(rng.standard_normal((3, 1, config.speaker_embedding_size)) * 0.3,
                           dtype=torch.float32, device=cuda_device)
    kw = dict(lengths=torch.tensor(lengths, dtype=torch.int32, device=cuda_device),
              speaker_embeddings=emb)
    packed = pack_flow_weights(p, config)
    before = fused_flow.launches
    got = fused_flow(x, p, config, packed=packed, **kw)
    again = fused_flow(x, p, config, packed=packed, **kw)
    unpacked = fused_flow(x, p, config, **kw)
    assert fused_flow.launches == before + 3
    assert torch.equal(got, again) and torch.equal(got, unpacked)
    assert float(got[2].abs().max()) == 0.0 and float(got[1, 137:].abs().max()) == 0.0
    _assert_close(got.cpu(), flow_reference(x, p, config, **kw).cpu(), atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("need_x", [True, False])
def test_trio_backward_kernel_matches_plain_on_card(cuda_device, need_x):
    """Kernel 5's backward kernels vs trio_backward_reference on the same saved
    activations at B=2, T=300 (not a multiple of the 32-frame step), C=128: each
    gradient within GRAD_RTOL = 1e-5 relative L2; dx only when asked; a repeated
    backward bit-identical; the launch count rising by one a call."""
    from vits_tpu_torch.ops.cuda.trio_grad import (
        flat_acts,
        trio_backward,
        trio_backward_reference,
        trio_forward_with_acts_reference,
    )

    rng = np.random.default_rng(12)
    x = torch.tensor(rng.standard_normal((2, 300, 128)), dtype=torch.float32, device=cuda_device)
    g = torch.tensor(rng.standard_normal((2, 300, 128)), dtype=torch.float32, device=cuda_device)
    blocks = _to(_blocks(rng, 128, scale=0.03), lambda a: torch.tensor(a, device=cuda_device))
    with torch.no_grad():
        saved = flat_acts(trio_forward_with_acts_reference(x, blocks, slope=SLOPE)[1])
        before = trio_backward.launches
        dx, dw = trio_backward(g, x, blocks, saved, slope=SLOPE, need_x=need_x)
        dx2, dw2 = trio_backward(g, x, blocks, saved, slope=SLOPE, need_x=need_x)
        want_dx, want_dw = trio_backward_reference(g, x, blocks, saved, slope=SLOPE,
                                                   need_x=need_x)
    assert trio_backward.launches == before + 2
    assert (dx is None) == (not need_x) and (want_dx is None) == (not need_x)
    pairs = list(zip(dw, want_dw)) + ([(dx, want_dx)] if need_x else [])
    for got, want in pairs:
        assert got.shape == want.shape
        rel = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
        assert rel <= 1e-5, rel
    for a, b in zip(dw + ([dx] if need_x else []), dw2 + ([dx2] if need_x else [])):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_warmup_keeps_every_warmed_flow_graph_on_card(cuda_device, monkeypatch):
    """Synthesizer.warmup over 10 flow shapes (batch 1 and 2 at the 5 frame
    capacities of 4 buckets x 2 rungs), more than a pack keeps unwarmed: a request
    of the first warmed shape then captures no new FlowWorkspace, and every
    warmed workspace is still the same."""
    from vits_tpu_torch.config import EngineConfig, VitsConfig
    from vits_tpu_torch.engine.synthesizer import Synthesizer
    from vits_tpu_torch.io import VitsTokenizer, random_params
    from vits_tpu_torch.ops.cuda import flow as flow_module

    config = dataclasses.replace(VitsConfig(), hidden_size=64, ffn_dim=128, num_hidden_layers=2,
                                 flow_size=32, upsample_initial_channel=64)
    vocab = "kzyuvdheswm' ablcfgijnopqrtx0123456789_-"
    tokenizer = VitsTokenizer(vocab={c: i for i, c in enumerate(vocab)}, pad_token="k",
                              unk_token="z")
    model = Synthesizer(config, tokenizer, random_params(config, seed=1, keep_training=False),
                        EngineConfig(use_pallas_flow=True, adaptive_capacity=False),
                        device=cuda_device)
    model.warmup(batch_sizes=(1, 2), overflow_ladder=1)
    pack = model._flow_pack()
    warmed = dict(pack._workspaces)
    assert len(warmed) == 10 > flow_module.WORKSPACES
    created = []

    class Counted(flow_module.FlowWorkspace):
        def __init__(self, *args):
            created.append(args[2:])
            super().__init__(*args)

    monkeypatch.setattr(flow_module, "FlowWorkspace", Counted)
    out = model.synthesize_raw(["hello"], seed=[0])
    assert out.waveform.shape[1] // config.total_upsample == model._frame_capacity(64)
    assert created == []
    assert all(pack._workspaces[key] is ws for key, ws in warmed.items())


@pytest.mark.cuda
def test_flow_kernel_from_four_threads_bit_identical_on_card(cuda_device, vctk_flow):
    """Kernel 6 called from 4 threads at once, 25 calls each, on one (1, 184,
    speakers) workspace (a stream window's shape), each thread with its own
    input, lengths and speaker: every output equals that input's
    single-thread output bit for bit (the same captured graph). Without the
    workspace's lock the threads' copies into the shared buffers interleave."""
    import threading

    from vits_tpu_torch.io.params import ParamView, from_jax_params
    from vits_tpu_torch.ops.cuda.flow import fused_flow, pack_flow_weights

    config, params = vctk_flow
    p = ParamView(from_jax_params(params, cuda_device))
    packed = pack_flow_weights(p, config)
    rng = np.random.default_rng(13)
    T = 184
    inputs = []
    for i in range(4):
        x = torch.tensor(_masked(rng, 1, T, config.flow_size, [T - 9 * i]), device=cuda_device)
        emb = torch.tensor(rng.standard_normal((1, 1, config.speaker_embedding_size)) * 0.3,
                           dtype=torch.float32, device=cuda_device)
        lens = torch.tensor([T - 9 * i], dtype=torch.int32, device=cuda_device)
        inputs.append((x, emb, lens))

    def call(x, emb, lens):
        return fused_flow(x, p, config, lengths=lens, speaker_embeddings=emb, packed=packed)

    want = [call(*args) for args in inputs]
    torch.cuda.synchronize()
    results = [[] for _ in inputs]
    errors = []

    def run(i):
        try:
            for _ in range(25):
                results[i].append(call(*inputs[i]))
        except Exception as exc:  # surfaced below
            errors.append(repr(exc))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(inputs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    torch.cuda.synchronize()
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(packed._workspaces) == 1
    for i, outs in enumerate(results):
        assert len(outs) == 25
        assert all(torch.equal(out, want[i]) for out in outs), i


# Stream vs one-shot (and mux vs solo) on the card: the kernels pick tiles and
# K splits per (B, T), so a window and the whole utterance sum in different
# orders; chip_smoke.py's STREAM_ATOL, with its reason there.
STREAM_ATOL = 1e-3


@pytest.fixture(scope="module")
def small_stream_engine():
    """A narrow multi-speaker model on the card with the flow kernel, the static
    frame capacity and float transfer (stream == one-shot at one capacity)."""
    from vits_tpu_torch.config import EngineConfig, VitsConfig
    from vits_tpu_torch.engine.synthesizer import Synthesizer
    from vits_tpu_torch.io import VitsTokenizer, random_params

    if not torch.cuda.is_available():  # a module fixture is set up before cuda_device skips
        pytest.skip("needs an NVIDIA GPU and nvcc (vits_tpu_torch CUDA kernels)")
    config = dataclasses.replace(VitsConfig(), hidden_size=64, ffn_dim=128, num_hidden_layers=2,
                                 flow_size=32, upsample_initial_channel=64, num_speakers=4,
                                 speaker_embedding_size=16)
    vocab = "kzyuvdheswm' ablcfgijnopqrtx0123456789_-"
    tokenizer = VitsTokenizer(vocab={c: i for i, c in enumerate(vocab)}, pad_token="k",
                              unk_token="z")
    # the exact tier: STREAM_ATOL assumes fp32
    return Synthesizer(config, tokenizer, random_params(config, seed=2, keep_training=False),
                       EngineConfig(use_pallas_flow=True, adaptive_capacity=False,
                                    transfer_int16=False, **EngineConfig.fidelity_kwargs("exact")),
                       device="cuda")


STREAM_TEXT = "the quick brown fox jumps over the lazy dog, twice over."


@pytest.mark.cuda
def test_stream_matches_oneshot_and_warmup_keeps_flow_graphs_on_card(
        cuda_device, small_stream_engine, monkeypatch):
    """After StreamingDecoder.warmup a stream captures no new FlowWorkspace and
    equals the one-shot decode within STREAM_ATOL; zero margins do not."""
    from vits_tpu_torch.engine.streaming import StreamingDecoder
    from vits_tpu_torch.ops.cuda import flow as flow_module

    model = small_stream_engine
    stream = StreamingDecoder(model)
    stream.warmup(token_buckets=(64, 128), overflow_ladder=2)
    created = []

    class Counted(flow_module.FlowWorkspace):
        def __init__(self, *args):
            created.append(args[2:])
            super().__init__(*args)

    monkeypatch.setattr(flow_module, "FlowWorkspace", Counted)
    streamed = stream.synthesize_streaming(STREAM_TEXT, seed=4, speaker_id=2)
    assert created == []
    monkeypatch.undo()
    oneshot = model.synthesize(STREAM_TEXT, seed=4, speaker_id=2)
    assert streamed.shape == oneshot.shape
    assert float(np.abs(streamed - oneshot).max()) <= STREAM_ATOL
    zero = StreamingDecoder(model, margin_frames=0, flow_margin_frames=0)
    loose = zero.synthesize_streaming(STREAM_TEXT, seed=4, speaker_id=2)
    assert float(np.abs(loose - oneshot).max()) > 10 * STREAM_ATOL


@pytest.mark.cuda
def test_mux_streams_match_solo_streams_on_card(cuda_device, small_stream_engine):
    """Three concurrent streams through the mux (batched windows, kernel 6 at
    batch 2-4) each within STREAM_ATOL of its solo stream; windows coalesced."""
    import threading

    from vits_tpu_torch.engine.mux import MultiplexedStreamingDecoder
    from vits_tpu_torch.engine.streaming import StreamingDecoder

    model = small_stream_engine
    texts = [STREAM_TEXT, "hello world.", "see you soon, my friend, see you soon."]
    speakers = [0, 3, None]
    solo = StreamingDecoder(model)
    want = [solo.synthesize_streaming(t, seed=i, speaker_id=s)
            for i, (t, s) in enumerate(zip(texts, speakers))]
    mux = MultiplexedStreamingDecoder(model, max_batch=4, batch_window_ms=50.0)
    results, errors = [None] * 3, []

    def run(i):
        try:
            results[i] = mux.synthesize_streaming(texts[i], seed=i, speaker_id=speakers[i])
        except Exception as exc:  # surfaced below
            errors.append(repr(exc))

    try:
        mux.warmup(token_buckets=(64,))
        threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        mux.stop()
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for got, expected in zip(results, want):
        assert got.shape == expected.shape
        assert float(np.abs(got - expected).max()) <= STREAM_ATOL
    assert mux.stats["dispatches"] < mux.stats["windows"], mux.stats


# --------------------------------------------------------------------------- #
# The precision tiers (vits_tpu_torch/ops/tiers.py) on the card: each kernel at
# each tier against its plain twin at the same tier, on the card. Bounds
# relative to max(1, |output|): 0.03 at "fast" (the bf16 bound of
# tests/test_torch_precision.py: bf16 operands; the twin rounds at the same
# points, the kernel sums in another order, so a rounding may flip); at
# "high" twice that file's 1e-4 -- kernel and twin each hold bf16x3's error
# against fp32 within it, and an fp32 difference between them moves a split
# (the stage at 64->32 with conv_post reached 1.3e-4); at "highest" (also
# with int8 weights and fp32 values) chip_smoke.py's KERNEL_TOL, 5e-5: fp32
# sums in another order over up to 126 taps x C inputs, then conv_post and
# tanh (that stage reached 1.2e-5).
# --------------------------------------------------------------------------- #

TIER_BOUNDS = {"fast": 0.03, "high": 2e-4, "highest": 5e-5}
# (tier, vocoder weight format) pairs the engine runs kernels B and C at
VOCODER_TIER_CASES = [("fast", "bfloat16"), ("fast", "int8"), ("high", "float32"),
                      ("highest", "float32"), ("highest", "int8")]


def _tier(name):
    from vits_tpu_torch.ops.tiers import resolve_tier

    return resolve_tier(None if name == "fast" else name, "bfloat16" if name == "fast" else None)


def _tier_blocks(blocks, fmt, device):
    """Resblock weights in a pack format (models/hifigan.py::precompute_vocoder_packs)."""
    from vits_tpu_torch.models.hifigan import quantize_out_channels

    out = []
    for blk in _to(blocks, lambda a: torch.tensor(a, device=device)):
        for w, s in (("w1", "s1"), ("w2", "s2")):
            if fmt == "int8":
                blk[w], blk[s] = quantize_out_channels(blk[w], (1, 2))
            elif fmt == "bfloat16":
                blk[w] = blk[w].to(torch.bfloat16)
        out.append(blk)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name,fmt", VOCODER_TIER_CASES)
def test_trio_kernel_tiers_match_plain_on_card(cuda_device, name, fmt):
    """Kernel B at each tier and weight format (C=128, a row ending mid-tile)."""
    rng = np.random.default_rng(3)
    lengths = [1000, 437]
    tier = _tier(name)
    x = torch.tensor(_masked(rng, 2, 1000, 128, lengths), device=cuda_device)
    x = x.to(tier.value_dtype)
    blocks = _tier_blocks(_blocks(rng, 128), fmt, cuda_device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    before = fused_resblock_trio.launches
    got = fused_resblock_trio(x, blocks, slope=SLOPE, lengths=lens, tier=tier)
    assert fused_resblock_trio.launches == before + 1 and got.dtype == x.dtype
    want = resblock_trio_reference(x, blocks, slope=SLOPE, lengths=lens, tier=tier)
    assert float(got[1, 437:].abs().max()) == 0.0
    _assert_close(got.float().cpu(), want.float().cpu(), atol=TIER_BOUNDS[name])


@pytest.mark.cuda
@pytest.mark.parametrize("C_in,C_out,final", [(128, 64, False), (64, 32, True), (32, 16, False),
                                              (16, 8, True)])
@pytest.mark.parametrize("name,fmt", VOCODER_TIER_CASES)
def test_stage_kernel_tiers_match_plain_on_card(cuda_device, name, fmt, C_in, C_out, final):
    """Kernel C at each tier and weight format: MMS's tail (B's conv for the
    resblocks) and HiFi-GAN V2's (the narrow conv), with and without conv_post."""
    from vits_tpu_torch.models.hifigan import quantize_out_channels

    rng = np.random.default_rng(C_out)
    lengths = [300, 77]
    tier = _tier(name)
    x = torch.tensor(_masked(rng, 2, 300, C_in, lengths), device=cuda_device)
    dev = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda_device)  # noqa: E731
    up_w, up_b = dev(rng.standard_normal((4, C_in, C_out)) * 0.1), dev(rng.standard_normal(C_out) * 0.1)
    w_post = dev(rng.standard_normal((7, C_out, 1)) * 0.3)
    up_scale = post_scale = None
    if fmt == "int8":
        up_w, up_scale = quantize_out_channels(up_w, (0, 1))
        w_post, post_scale = quantize_out_channels(w_post, (0, 1))
    elif fmt == "bfloat16":
        up_w, w_post = up_w.to(torch.bfloat16), w_post.to(torch.bfloat16)
    kw = dict(stride=2, up_padding=1, slope=SLOPE, tier=tier, up_scale=up_scale,
              lengths=torch.tensor(lengths, dtype=torch.int32, device=cuda_device),
              final_conv=(w_post, 3, post_scale) if final else None, chain=not final)
    blocks = _tier_blocks(_blocks(rng, C_out, scale=0.1), fmt, cuda_device)
    x = x.to(tier.value_dtype)
    before = fused_stage.launches
    got = fused_stage(x, up_w, up_b, blocks, **kw)
    assert fused_stage.launches == before + 1
    assert got.dtype == (torch.float32 if final else tier.value_dtype)
    want = stage_reference(x, up_w, up_b, blocks, **kw)
    _assert_close(got.float().cpu(), want.float().cpu(), atol=TIER_BOUNDS[name])


@pytest.mark.cuda
@pytest.mark.parametrize("C", [32, 64])
@pytest.mark.parametrize("name", list(TIER_BOUNDS))
def test_resblock_kernel_tiers_match_plain_on_card(cuda_device, name, C):
    """Kernel 7 at each tier (fp32 in and out; with bf16 values its window and
    each pair's output rounded to bf16)."""
    from vits_tpu_torch.ops.cuda.resblock import fused_resblock, resblock_reference

    rng = np.random.default_rng(C)
    lengths = [1000, 437]
    tier = _tier(name)
    x = torch.tensor(_masked(rng, 2, 1000, C, lengths), device=cuda_device)
    block = _to(_blocks(rng, C, ks=(11,), scale=0.1),
                lambda a: torch.tensor(a, device=cuda_device))[0]
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    before = fused_resblock.launches
    got = fused_resblock(x, block, slope=SLOPE, lengths=lens, tier=tier)
    assert fused_resblock.launches == before + 1
    want = resblock_reference(x, block, slope=SLOPE, lengths=lens, tier=tier)
    _assert_close(got.cpu(), want.cpu(), atol=TIER_BOUNDS[name])


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TIER_BOUNDS))
def test_flow_kernel_tiers_match_plain_on_card(cuda_device, vctk_flow, name):
    """Kernel 6 at each tier (fp32 values, every product's operands rounded),
    a graph captured per tier on one pack; "fast" differs from "highest"."""
    from vits_tpu_torch.io.params import ParamView, from_jax_params
    from vits_tpu_torch.ops.cuda.flow import flow_packed_reference, fused_flow, pack_flow_weights
    from vits_tpu_torch.ops.tiers import resolve_tier

    config, params = vctk_flow
    p = ParamView(from_jax_params(params, cuda_device))
    packed = pack_flow_weights(p, config)
    rng = np.random.default_rng(9)
    lengths = [150, 61]
    x = torch.tensor(_masked(rng, 2, 150, config.flow_size, lengths), device=cuda_device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    tier = resolve_tier(None if name == "fast" else name)
    got = fused_flow(x, p, config, lengths=lens, packed=packed, tier=tier)
    exact = fused_flow(x, p, config, lengths=lens, packed=packed)
    assert len(packed._workspaces) == (1 if name == "highest" else 2)
    want = flow_packed_reference(x, packed, config, lengths=lens, tier=tier)
    _assert_close(got.cpu(), want.cpu(), atol=max(TIER_BOUNDS[name], 1e-4))
    if name == "fast":
        assert float((got - exact).abs().max()) > 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TIER_BOUNDS))
def test_attention_kernel_tiers_match_plain_on_card(cuda_device, name):
    """Kernel A at each tier, B=2, L=512, one row 301 long."""
    from vits_tpu_torch.ops.tiers import resolve_tier

    rng = np.random.default_rng(4)
    B, H, L, d, w = 2, 2, 512, 96, 4
    dev = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda_device)  # noqa: E731
    q, k, v = (dev(rng.standard_normal((B, H, L, d)) * 0.5) for _ in range(3))
    rel_k, rel_v = (dev(rng.standard_normal((2 * w + 1, d)) * 0.5) for _ in range(2))
    lens = torch.tensor([512, 301], dtype=torch.int32, device=cuda_device)
    tier = resolve_tier(None if name == "fast" else name)
    got = flash_rel_attention(q, k, v, rel_k, rel_v, window=w, lengths=lens, tier=tier)
    want = rel_attention_reference(q, k, v, rel_k, rel_v, window=w, lengths=lens, tier=tier)
    _assert_close(got.cpu(), want.cpu(), atol=TIER_BOUNDS[name])


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
def test_engine_default_is_the_fast_tier_on_card(cuda_device, quantized):
    """EngineConfig() on the card runs the fast tier: bf16 values, bf16 packs
    (int8 for a quantized checkpoint) of kernels B and C, through A, B and C."""
    from vits_tpu_torch.config import EngineConfig, VitsConfig
    from vits_tpu_torch.engine.synthesizer import Synthesizer
    from vits_tpu_torch.io import VitsTokenizer, random_params
    from vits_tpu_torch.io.quantize import quantize_params
    from vits_tpu_torch.ops.tiers import FAST

    config = dataclasses.replace(VitsConfig(), hidden_size=64, ffn_dim=128, num_hidden_layers=2,
                                 flow_size=32, upsample_initial_channel=256,
                                 upsample_rates=(2, 2, 2), upsample_kernel_sizes=(4, 4, 4))
    vocab = "kzyuvdheswm' ablcfgijnopqrtx0123456789_-"
    tokenizer = VitsTokenizer(vocab={c: i for i, c in enumerate(vocab)}, pad_token="k",
                              unk_token="z")
    params = random_params(config, seed=1, keep_training=False)
    if quantized:
        params = quantize_params(params)
    model = Synthesizer(config, tokenizer, params, EngineConfig(), device=cuda_device)
    assert model.tiers.stage(0).mode == FAST and model.tiers.attention.mode == FAST
    counts = {fn: fn.launches for fn in (fused_resblock_trio, fused_stage, flash_rel_attention)}
    audio = model.synthesize("hello there, how are you", seed=0)
    assert np.isfinite(audio).all() and audio.size > 0
    assert all(fn.launches > n for fn, n in counts.items())
    fmt = torch.int8 if quantized else torch.bfloat16
    packs = model._vocoder_packs()
    assert packs[0]["blocks"][0]["w1"].dtype == fmt and packs[1]["up_w"].dtype == fmt



# The bf16 training tier (ops/tiers.py::BF16_TRAIN_TIER) of kernels A with lse, 4 and 5:
# bf16 storage in and out. The plain twins run the same function in bf16 PyTorch ops
# on the card (kernel 5) or in fp32 on the bf16 values (A and 4), summing in other
# orders, so a stored bf16 value may land one ulp away: BF16_ATOL is two bf16 ulps
# of max(1, |output|) for A and 4, and kernel 5's rounding after every step lets
# such an ulp travel, held by relative L2 error BF16_RTOL per tensor.
BF16_ATOL = 2.0**-7
BF16_RTOL = 2e-2


def _rel_l2(got, want):
    got, want = got.float(), want.float()
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


@pytest.mark.cuda
def test_attention_kernels_bf16_match_plain_on_card(cuda_device):
    """Kernels A (with lse) and 4 on bf16 storage at the training shape (L=512,
    lengths 512 and 300, MMS's head_dim 96): outputs in bf16 (lse fp32), within
    BF16_ATOL of the plain twins at the same tier; a repeated backward bit-identical;
    fp32 tensors at the bf16 tier refused."""
    from vits_tpu_torch.ops.cuda.attention import rel_attention_plain
    from vits_tpu_torch.ops.cuda.attention_grad import (
        rel_attention_bwd,
        rel_attention_bwd_reference,
    )
    from vits_tpu_torch.ops.tiers import BF16_TRAIN_TIER as tier

    rng = np.random.default_rng(21)
    B, H, L, d, w = 2, 2, 512, 96, 4
    dev = lambda *s: torch.tensor(  # noqa: E731
        rng.standard_normal(s) * 0.5, device=cuda_device).to(torch.bfloat16)
    q, k, v, dout = (dev(B, H, L, d) for _ in range(4))
    rel_k, rel_v = dev(2 * w + 1, d), dev(2 * w + 1, d)
    lengths = [512, 300]
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    out, lse = flash_rel_attention(q, k, v, rel_k, rel_v, window=w, lengths=lens,
                                   return_lse=True, tier=tier)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    want, want_lse = rel_attention_plain(q, k, v, rel_k, rel_v, window=w, lengths=lens,
                                         return_lse=True, tier=tier)
    _assert_close(out.float().cpu(), want.float().cpu(), BF16_ATOL)
    _assert_close(lse.cpu(), want_lse.cpu())
    got = rel_attention_bwd(q, k, v, rel_k, rel_v, lse, dout, out, window=w, lengths=lens,
                            tier=tier)
    want = rel_attention_bwd_reference(q, k, v, rel_k, rel_v, lse, dout, out, window=w,
                                       lengths=lens, tier=tier)
    assert all(g.dtype == torch.bfloat16 for g in got)
    for g, ref in zip(got[:3], want[:3]):
        for b, n in enumerate(lengths):
            _assert_close(g[b, :, :n].float().cpu(), ref[b, :, :n].float().cpu(), BF16_ATOL)
    for g, ref in zip(got[3:], want[3:]):
        _assert_close(g.float().cpu(), ref.float().cpu(), BF16_ATOL)
    again = rel_attention_bwd(q, k, v, rel_k, rel_v, lse, dout, out, window=w, lengths=lens,
                              tier=tier)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    with pytest.raises(ValueError):
        flash_rel_attention(q.float(), k.float(), v.float(), rel_k.float(), rel_v.float(),
                            window=w, lengths=lens, tier=tier)


@pytest.mark.cuda
@pytest.mark.parametrize("C,T", [(256, 256), (128, 300)])
def test_trio_kernels_bf16_match_plain_on_card(cuda_device, C, T):
    """Kernel 5 on bf16 storage at the training tier: the forward's output and saved
    activations, then the backward on the twin's activations, against the twins in
    bf16 PyTorch ops on the card (BF16_RTOL); bf16 outputs; a repeated backward
    bit-identical; fp32 inputs at the bf16 tier refused."""
    from vits_tpu_torch.ops.cuda.trio_grad import (
        flat_acts,
        trio_backward,
        trio_backward_reference,
        trio_forward_with_acts,
        trio_forward_with_acts_reference,
    )
    from vits_tpu_torch.ops.tiers import BF16_TRAIN_TIER as tier

    rng = np.random.default_rng(22)
    bf = lambda a: torch.tensor(a, device=cuda_device).to(torch.bfloat16)  # noqa: E731
    x = bf(rng.standard_normal((2, T, C)))
    g = bf(rng.standard_normal((2, T, C)))
    blocks = _to(_blocks(rng, C, scale=0.03), bf)
    with torch.no_grad():
        out, acts = trio_forward_with_acts(x, blocks, slope=SLOPE, tier=tier)
        want, want_acts = trio_forward_with_acts_reference(x, blocks, slope=SLOPE)
        assert out.dtype == torch.bfloat16
        assert _rel_l2(out, want) <= BF16_RTOL
        for a, b in zip(flat_acts(acts), flat_acts(want_acts)):
            assert a.dtype == torch.bfloat16 and _rel_l2(a, b) <= BF16_RTOL
        saved = flat_acts(want_acts)
        dx, dw = trio_backward(g, x, blocks, saved, slope=SLOPE, tier=tier)
        dx2, dw2 = trio_backward(g, x, blocks, saved, slope=SLOPE, tier=tier)
        want_dx, want_dw = trio_backward_reference(g, x, blocks, saved, slope=SLOPE)
    for got, ref in [(dx, want_dx), *zip(dw, want_dw)]:
        assert got.dtype == torch.bfloat16 and _rel_l2(got, ref) <= BF16_RTOL
    assert all(torch.equal(a, b) for a, b in zip([dx, *dw], [dx2, *dw2]))
    with pytest.raises(ValueError):
        trio_forward_with_acts(x.float(), blocks, slope=SLOPE, tier=tier)


# bf16 serving (ops/tiers.py::Tiers.bf16_compute, EngineConfig(compute_dtype="bfloat16")):
# kernels B, C and 7 compute XLA's masked bf16 graph of the plain stage, rounding to bf16
# after every step; kernels A and 6 take and give bf16 at their tier, staging fp32. The
# plain twins run the same graph in bf16 PyTorch ops on the card (B, C, 7: cuDNN's and
# cuBLAS's sums in other orders, so a rounded step may land one ulp away and travel:
# BF16_RTOL relative L2 per tensor) or in fp32 on the bf16 values (A, 6: two bf16 ulps,
# BF16_ATOL).


def _bf16_blocks(rng, C, device, ks=(3, 7, 11), scale=0.05):
    return _to(_blocks(rng, C, ks=ks, scale=scale),
               lambda a: torch.tensor(a, device=device).to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("C,T", [(256, 320), (128, 1000)])
def test_trio_kernel_bf16_serving_matches_plain_on_card(cuda_device, C, T):
    """Kernel B at bf16 serving: bf16 activations, weights and biases, a row
    ending mid-tile (zero past it), bf16 out, within BF16_RTOL of XLA's graph."""
    from vits_tpu_torch.ops.tiers import BF16_COMPUTE_TIER as tier

    rng = np.random.default_rng(31)
    lengths = [T, T // 2 - 63]
    x = torch.tensor(_masked(rng, 2, T, C, lengths), device=cuda_device).to(torch.bfloat16)
    blocks = _bf16_blocks(rng, C, cuda_device, scale=0.03)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    before = fused_resblock_trio.launches
    got = fused_resblock_trio(x, blocks, slope=SLOPE, lengths=lens, tier=tier)
    assert fused_resblock_trio.launches == before + 1 and got.dtype == torch.bfloat16
    want = resblock_trio_reference(x, blocks, slope=SLOPE, lengths=lens, tier=tier)
    assert float(got[1, lengths[1]:].float().abs().max()) == 0.0
    assert _rel_l2(got, want) <= BF16_RTOL
    with pytest.raises(ValueError):
        fused_resblock_trio(x.float(), blocks, slope=SLOPE, lengths=lens, tier=tier)


@pytest.mark.cuda
@pytest.mark.parametrize("C_in,C_out,final", [(128, 64, False), (64, 32, True), (32, 16, False),
                                              (16, 8, True)])
def test_stage_kernel_bf16_serving_matches_plain_on_card(cuda_device, C_in, C_out, final):
    """Kernel C at bf16 serving (per-phase upsampler, the resblocks' bf16 convs on
    B's tile or the narrow one, the bf16 conv_post): bf16 out, within BF16_RTOL."""
    from vits_tpu_torch.ops.tiers import BF16_COMPUTE_TIER as tier

    rng = np.random.default_rng(C_out + 1)
    lengths = [300, 77]
    x = torch.tensor(_masked(rng, 2, 300, C_in, lengths), device=cuda_device).to(torch.bfloat16)
    dev = lambda a: torch.tensor(a, device=cuda_device).to(torch.bfloat16)  # noqa: E731
    up_w, up_b = dev(rng.standard_normal((4, C_in, C_out)) * 0.1), dev(rng.standard_normal(C_out) * 0.1)
    w_post = dev(rng.standard_normal((7, C_out, 1)) * 0.3)
    kw = dict(stride=2, up_padding=1, slope=SLOPE, tier=tier,
              lengths=torch.tensor(lengths, dtype=torch.int32, device=cuda_device),
              final_conv=(w_post, 3) if final else None)
    blocks = _bf16_blocks(rng, C_out, cuda_device, scale=0.1)
    before = fused_stage.launches
    got = fused_stage(x, up_w, up_b, blocks, **kw)
    assert fused_stage.launches == before + 1 and got.dtype == torch.bfloat16
    want = stage_reference(x, up_w, up_b, blocks, **kw)
    assert got.shape == want.shape and _rel_l2(got, want) <= BF16_RTOL
    assert float(got[1, 2 * lengths[1]:].float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("C", [32, 64])
def test_resblock_kernel_bf16_serving_matches_plain_on_card(cuda_device, C):
    """Kernel 7 at bf16 serving: a stage's three resblocks summed in place and
    divided by three (``into``, ``divisor``), as the vocoder calls it."""
    from vits_tpu_torch.ops.cuda.resblock import fused_resblock
    from vits_tpu_torch.ops.tiers import BF16_COMPUTE_TIER as tier

    rng = np.random.default_rng(C + 2)
    lengths = [1000, 437]
    x = torch.tensor(_masked(rng, 2, 1000, C, lengths), device=cuda_device).to(torch.bfloat16)
    blocks = _bf16_blocks(rng, C, cuda_device, scale=0.1)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)

    def stage(x):
        out = None
        for j, block in enumerate(blocks):
            out = fused_resblock(x, block, slope=SLOPE, lengths=lens, into=out, tier=tier,
                                 divisor=3 if j == 2 else 1)
        return out

    before = fused_resblock.launches
    got = stage(x)
    assert fused_resblock.launches == before + 3 and got.dtype == torch.bfloat16
    want = resblock_trio_reference(x, blocks, slope=SLOPE, lengths=lens, tier=tier)
    assert _rel_l2(got, want) <= BF16_RTOL
    assert float(got[1, 437:].float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TIER_BOUNDS))
def test_flow_kernel_bf16_serving_matches_plain_on_card(cuda_device, vctk_flow, name):
    """Kernel 6 at bf16 serving with speakers: bf16 in and out, its own graph beside
    the fp32 one, within BF16_ATOL of the twin (fp32 staging on the bf16 values)."""
    from vits_tpu_torch.io.params import ParamView, from_jax_params
    from vits_tpu_torch.ops.cuda.flow import (
        flow_compute16_reference,
        fused_flow,
        pack_flow_weights,
    )
    from vits_tpu_torch.ops.tiers import resolve_tier

    config, params = vctk_flow
    p = ParamView({k: v.to(torch.bfloat16) for k, v in
                   from_jax_params(params, cuda_device).items()})
    packed = pack_flow_weights(p, config)
    rng = np.random.default_rng(10)
    lengths = [150, 61]
    x = torch.tensor(_masked(rng, 2, 150, config.flow_size, lengths),
                     device=cuda_device).to(torch.bfloat16)
    spk = torch.tensor(rng.standard_normal((2, 1, 256)), device=cuda_device).to(torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    tier = resolve_tier(None if name == "fast" else name)._replace(bf16_compute=True)
    got = fused_flow(x, p, config, lengths=lens, speaker_embeddings=spk, packed=packed, tier=tier)
    assert got.dtype == torch.bfloat16
    want = flow_compute16_reference(x, packed, p, config, lengths=lens,
                                    speaker_embeddings=spk, tier=tier)
    _assert_close(got.float().cpu(), want.float().cpu(), BF16_ATOL)
    assert float(got[1, 61:].float().abs().max()) == 0.0
    with pytest.raises(ValueError):
        fused_flow(x.float(), p, config, lengths=lens, packed=packed, tier=tier)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TIER_BOUNDS))
def test_attention_kernel_bf16_serving_matches_plain_on_card(cuda_device, name):
    """Kernel A at bf16 serving at each tier: bf16 q, k, v and tables, no lse,
    bf16 out within BF16_ATOL of the twin at the same tier."""
    from vits_tpu_torch.ops.cuda.attention import rel_attention_plain
    from vits_tpu_torch.ops.tiers import Tier, resolve_tier

    rng = np.random.default_rng(5)
    B, H, L, d, w = 2, 2, 512, 96, 4
    dev = lambda *s: torch.tensor(  # noqa: E731
        rng.standard_normal(s) * 0.5, device=cuda_device).to(torch.bfloat16)
    q, k, v = (dev(B, H, L, d) for _ in range(3))
    rel_k, rel_v = dev(2 * w + 1, d), dev(2 * w + 1, d)
    lens = torch.tensor([512, 301], dtype=torch.int32, device=cuda_device)
    mode = resolve_tier(None if name == "fast" else name).mode
    before = flash_rel_attention.launches
    got = flash_rel_attention(q, k, v, rel_k, rel_v, window=w, lengths=lens,
                              tier=Tier(mode, False, True))
    assert flash_rel_attention.launches == before + 1 and got.dtype == torch.bfloat16
    want = rel_attention_plain(q, k, v, rel_k, rel_v, window=w, lengths=lens, tier=Tier(mode))
    _assert_close(got.float().cpu(), want.float().cpu(), BF16_ATOL)


# Kernels A and 4 past head_dim 128 (two column chunks) and window 15 (2w + 1 > 32
# offsets), up to their ceiling (ops/cuda/attention.py::MAX_HEAD_DIM, MAX_WINDOW):
# every mode they have, against the plain twins at the same tier and tolerance as
# at MMS's d = 96, w = 4. Rows: one whole, one 0 long, one ending mid-tile.
WIDE_SHAPES = [(160, 16), (192, 32), (256, 4), (256, 32)]
WIDE_LENGTHS = [200, 0, 77]


def _wide_inputs(seed, d, w, device, dtype=torch.float32, with_dout=False):
    rng = np.random.default_rng(seed)
    B, H, L = len(WIDE_LENGTHS), 2, WIDE_LENGTHS[0]
    dev = lambda *s: torch.tensor(  # noqa: E731
        rng.standard_normal(s) * 0.5, dtype=torch.float32, device=device).to(dtype)
    q, k, v = (dev(B, H, L, d) for _ in range(3))
    tables = dev(2 * w + 1, d), dev(2 * w + 1, d)
    lens = torch.tensor(WIDE_LENGTHS, dtype=torch.int32, device=device)
    return (q, k, v, *tables), lens, (dev(B, H, L, d) if with_dout else None)


def _assert_grads_close(got, want, atol=ATOL):
    """dq, dk, dv over each row's valid region (zeros in a length-0 row), the tables whole."""
    for g, ref in zip(got[:3], want[:3]):
        for b, n in enumerate(WIDE_LENGTHS):
            if n:
                _assert_close(g[b, :, :n].float().cpu(), ref[b, :, :n].float().cpu(), atol)
            else:
                assert float(g[b].float().abs().max()) == 0.0
    for g, ref in zip(got[3:], want[3:]):
        _assert_close(g.float().cpu(), ref.float().cpu(), atol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TIER_BOUNDS))
@pytest.mark.parametrize("d,w", WIDE_SHAPES)
def test_attention_kernel_wide_tiers_match_plain_on_card(cuda_device, d, w, name):
    """Kernel A at each tier on fp32 values past d = 128 and w = 15."""
    from vits_tpu_torch.ops.tiers import resolve_tier

    args, lens, _ = _wide_inputs(41, d, w, cuda_device)
    tier = resolve_tier(None if name == "fast" else name)
    before = flash_rel_attention.launches
    got = flash_rel_attention(*args, window=w, lengths=lens, tier=tier)
    assert flash_rel_attention.launches == before + 1 and bool(torch.isfinite(got).all())
    want = rel_attention_reference(*args, window=w, lengths=lens, tier=tier)
    _assert_close(got.cpu(), want.cpu(), atol=TIER_BOUNDS[name])


@pytest.mark.cuda
@pytest.mark.parametrize("d,w", WIDE_SHAPES)
def test_attention_lse_and_backward_wide_match_plain_on_card(cuda_device, d, w):
    """Kernel A with lse and kernel 4 at the exact tier (fp32 training) past d = 128
    and w = 15; a repeated backward bit-identical (no atomics across the chunks)."""
    from vits_tpu_torch.ops.cuda.attention_grad import (
        rel_attention_bwd,
        rel_attention_bwd_reference,
    )

    args, lens, dout = _wide_inputs(42, d, w, cuda_device, with_dout=True)
    out, lse = flash_rel_attention(*args, window=w, lengths=lens, return_lse=True)
    want, want_lse = rel_attention_reference(*args, window=w, lengths=lens, return_lse=True)
    _assert_close(out.cpu(), want.cpu())
    for b in range(len(WIDE_LENGTHS)):
        _assert_close(lse[b].cpu(), want_lse[b].cpu())
    before = rel_attention_bwd.launches
    got = rel_attention_bwd(*args, lse, dout, out, window=w, lengths=lens)
    assert rel_attention_bwd.launches == before + 1
    _assert_grads_close(got, rel_attention_bwd_reference(*args, lse, dout, out, window=w,
                                                         lengths=lens))
    again = rel_attention_bwd(*args, lse, dout, out, window=w, lengths=lens)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("d,w", WIDE_SHAPES)
def test_attention_kernels_wide_bf16_match_plain_on_card(cuda_device, d, w):
    """Kernels A (with and without lse) and 4 on bf16 storage at the bf16 training
    tier past d = 128 and w = 15, within BF16_ATOL of the twins."""
    from vits_tpu_torch.ops.cuda.attention import rel_attention_plain
    from vits_tpu_torch.ops.cuda.attention_grad import (
        rel_attention_bwd,
        rel_attention_bwd_reference,
    )
    from vits_tpu_torch.ops.tiers import BF16_TRAIN_TIER as tier

    args, lens, dout = _wide_inputs(43, d, w, cuda_device, torch.bfloat16, with_dout=True)
    plain = flash_rel_attention(*args, window=w, lengths=lens, tier=tier)
    out, lse = flash_rel_attention(*args, window=w, lengths=lens, return_lse=True, tier=tier)
    want, want_lse = rel_attention_plain(*args, window=w, lengths=lens, return_lse=True,
                                         tier=tier)
    assert plain.dtype == out.dtype == torch.bfloat16 and torch.equal(plain, out)
    _assert_close(out.float().cpu(), want.float().cpu(), BF16_ATOL)
    for b in range(len(WIDE_LENGTHS)):
        _assert_close(lse[b].cpu(), want_lse[b].cpu())
    got = rel_attention_bwd(*args, lse, dout, out, window=w, lengths=lens, tier=tier)
    assert all(g.dtype == torch.bfloat16 for g in got)
    _assert_grads_close(got, rel_attention_bwd_reference(*args, lse, dout, out, window=w,
                                                         lengths=lens, tier=tier), BF16_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TIER_BOUNDS))
@pytest.mark.parametrize("d,w", WIDE_SHAPES)
def test_attention_kernel_wide_bf16_serving_matches_plain_on_card(cuda_device, d, w, name):
    """Kernel A at bf16 serving at each tier past d = 128 and w = 15."""
    from vits_tpu_torch.ops.cuda.attention import rel_attention_plain
    from vits_tpu_torch.ops.tiers import Tier, resolve_tier

    args, lens, _ = _wide_inputs(44, d, w, cuda_device, torch.bfloat16)
    mode = resolve_tier(None if name == "fast" else name).mode
    got = flash_rel_attention(*args, window=w, lengths=lens, tier=Tier(mode, False, True))
    assert got.dtype == torch.bfloat16
    want = rel_attention_plain(*args, window=w, lengths=lens, tier=Tier(mode))
    _assert_close(got.float().cpu(), want.float().cpu(), BF16_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d,w", [(257, 4), (96, 33)])
def test_attention_kernels_refuse_past_the_ceiling_on_card(cuda_device, d, w):
    """Past head_dim 256 or window 32 both kernels raise with the numbers, and
    neither takes its plain twin."""
    from vits_tpu_torch.ops.cuda.attention_grad import rel_attention_bwd

    args, lens, dout = _wide_inputs(45, d, w, cuda_device, with_dout=True)
    counts = flash_rel_attention.launches, rel_attention_bwd.launches
    with pytest.raises(ValueError, match=f"head_dim {d}, window {w}"):
        flash_rel_attention(*args, window=w, lengths=lens)
    lse = torch.zeros(args[0].shape[:3], dtype=torch.float32, device=cuda_device)
    with pytest.raises(ValueError, match=f"head_dim {d}, window {w}"):
        rel_attention_bwd(*args, lse, dout, args[0], window=w, lengths=lens)
    assert (flash_rel_attention.launches, rel_attention_bwd.launches) == counts


@pytest.mark.cuda
def test_engine_bf16_serving_on_card(cuda_device):
    """EngineConfig(compute_dtype="bfloat16") on the card: bf16 parameters, no packs,
    kernels A, B, C and 6 launched, finite fp32 PCM; on one NoiseOverride the
    card's frame count within 10% of the CPU plain path's (the bf16 duration
    predictor turns the one-ulp differences of cuBLAS's and cuDNN's summation
    orders into up to ~0.5 of log duration: chip_smoke.py::DURATION_RTOL)."""
    from vits_tpu_torch.config import EngineConfig, VitsConfig
    from vits_tpu_torch.engine.synthesizer import Synthesizer
    from vits_tpu_torch.io import VitsTokenizer, random_params
    from vits_tpu_torch.models import vits
    from vits_tpu_torch.ops.cuda.flow import fused_flow

    config = dataclasses.replace(VitsConfig(), hidden_size=64, ffn_dim=128, num_hidden_layers=2,
                                 flow_size=32, upsample_initial_channel=256,
                                 upsample_rates=(2, 2, 2), upsample_kernel_sizes=(4, 4, 4))
    vocab = "kzyuvdheswm' ablcfgijnopqrtx0123456789_-"
    tokenizer = VitsTokenizer(vocab={c: i for i, c in enumerate(vocab)}, pad_token="k",
                              unk_token="z")
    params = random_params(config, seed=1, keep_training=False)
    engine = EngineConfig(compute_dtype="bfloat16", use_pallas_flow=True)
    model = Synthesizer(config, tokenizer, params, engine, device=cuda_device)
    assert model.compute_dtype == torch.bfloat16 and model._vocoder_packs() == {}
    assert all(v.dtype == torch.bfloat16 for v in model.params.values())
    counts = {fn: fn.launches
              for fn in (fused_resblock_trio, fused_stage, flash_rel_attention, fused_flow)}
    audio = model.synthesize("hello there, how are you", seed=0)
    assert audio.dtype == np.float32 and np.isfinite(audio).all() and audio.size > 0
    assert all(fn.launches > n for fn, n in counts.items())
    cpu = Synthesizer(config, tokenizer, params, dataclasses.replace(
        engine, use_pallas_attention=True, use_pallas_vocoder=True), device="cpu")
    ids, mask = tokenizer.pad([tokenizer.encode("hello there, how are you")], pad_to=64)
    rng = np.random.default_rng(0)
    dur = torch.tensor(rng.standard_normal((1, 64, 2))).to(torch.bfloat16)
    prior = torch.tensor(rng.standard_normal((1, 256, 32))).to(torch.bfloat16)
    frames = []
    for m, dev in ((model, cuda_device), (cpu, torch.device("cpu"))):
        with torch.inference_mode():
            out = vits.synthesize(
                m.params, m.config, torch.tensor(ids, dtype=torch.long, device=dev),
                torch.tensor(mask, device=dev).to(torch.bfloat16), 256,
                noise=vits.NoiseOverride(dur.to(dev), prior.to(dev)),
                use_pallas_flow=True, flow_pack=m._flow_pack(), tiers=m.tiers)
        frames.append(int(out.frame_lengths[0]))
    assert abs(frames[0] - frames[1]) <= 0.1 * frames[1], frames


# Monotonic Alignment Search (csrc/align.cu) at ops/cuda/align.py's MAS_CASES. The
# kernel does the plain loop's fp32 add and compare per cell: alignments equal.
def mas_inputs(case: str, device):
    return tuple(torch.tensor(a, device=device) for a in cuda_align.mas_case(case))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(cuda_align.MAS_CASES))
def test_mas_kernel_equals_plain_on_card(cuda_device, case):
    from vits_tpu_torch.ops.cuda.align import mas_plan, monotonic_align, monotonic_align_reference

    inputs = mas_inputs(case, cuda_device)
    before = monotonic_align.launches
    got = monotonic_align(*inputs)
    torch.cuda.synchronize()
    assert monotonic_align.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == inputs[0].shape
    want = monotonic_align_reference(*(t.cpu() for t in inputs))
    assert torch.equal(got.cpu(), want), (case, mas_plan(*inputs[0].shape[1:], inputs[0].shape[0]))


@pytest.mark.cuda
def test_mas_kernel_launches_are_bit_identical(cuda_device):
    """Two launches at the training shape write the same bits: the wavefront's
    hand-offs and the cluster's zeros and ones leave no order to chance."""
    from vits_tpu_torch.ops.cuda.align import monotonic_align

    inputs = mas_inputs("training", cuda_device)
    first, second = monotonic_align(*inputs), monotonic_align(*inputs)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


@pytest.mark.cuda
def test_mas_kernel_refuses_what_it_does_not_take(cuda_device):
    from vits_tpu_torch.ops.cuda.align import monotonic_align

    ll, fmask, tmask = mas_inputs("padded", cuda_device)
    before = monotonic_align.launches
    with pytest.raises(ValueError, match="dtype"):
        monotonic_align(ll.double(), fmask, tmask)
    with pytest.raises(ValueError, match="dtype"):
        monotonic_align(ll, fmask.bool(), tmask)
    with pytest.raises(ValueError, match="not contiguous"):
        monotonic_align(ll.transpose(1, 2).contiguous().transpose(1, 2), fmask, tmask)
    with pytest.raises(ValueError, match="masks"):
        monotonic_align(ll, fmask[:, :-1].contiguous(), tmask)
    assert monotonic_align.launches == before


# --------------------------------------------------------------------------- #
# Hopper's route of B's and C's resblock conv at the fast tier on bf16 packs
# (csrc/conv_wgmma.cuh: TMA, an mbarrier ring, wgmma; ops/cuda/resblock.py::
# wgmma_plan and conv), one launch against its plain twin conv_reference: the
# tier's conv (bf16 operands, fp32 sums), the mask, the residual, the bf16 carry
# (round), the running sum (accumulate) and its scale, or the bf16 result
# (out16). Bound: the fast tier's 0.03 x max(1, max|plain|).
# --------------------------------------------------------------------------- #

# Every (C, k, dil) the three configurations (MMS-TTS, VCTK, small_config) run on
# the route (tests/test_torch_conv_plan.py::FAST_CONVS on the 64 grid): B at 256
# and 128, C's resblocks at 64; conv1 at each dilation, conv2 at 1.
WGMMA_CONVS = [(C, k, d) for C in (256, 128, 64) for k in (3, 7, 11) for d in (1, 3, 5)]
# (B, T, lengths): T off the 128-row tile, a length-0 row, rows shorter than one
# tile, a row ending mid-tile; B = 1 at B's phase-3 width (2560 + 37 off)
WGMMA_BATCHES = {1: (2523, [2523]), 4: (700, [700, 0, 37, 333])}


def _wgmma_case(device, C, k, dil, B, seed, bf16_x=False):
    rng = np.random.default_rng(seed)
    T, lengths = WGMMA_BATCHES[B]
    dev = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    x = dev(_masked(rng, B, T, C, lengths))
    if bf16_x:  # the value carry of the fast tier
        x = x.to(torch.bfloat16).float()
    w = dev(rng.standard_normal((k, C, C)) * 0.05).to(torch.bfloat16)
    bias, res = dev(rng.standard_normal(C) * 0.05), dev(_masked(rng, B, T, C, lengths))
    prev = dev(rng.standard_normal((B, T, C)))
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    return x, w, bias, res, prev, lens


def _wgmma_reference(x, w, bias, res, prev, lens, k, dil, accumulate, scale, round_):
    from vits_tpu_torch.ops.cuda.resblock import conv_reference

    return conv_reference(x, w, bias, res, lens, k, dil, SLOPE, _tier("fast"),
                          prev if accumulate else None, scale, round_)


def _wgmma_launch(x, w, bias, res, prev, lens, k, dil, accumulate, scale, round_, out16=False):
    from vits_tpu_torch.ops.cuda import stream_of
    from vits_tpu_torch.ops.cuda.resblock import conv

    out = prev.clone()
    o16 = torch.empty_like(x, dtype=torch.bfloat16) if out16 else None
    conv(x, out, w, bias, res, None, lens, k, dil, SLOPE, int(accumulate), scale, int(round_),
         o16, 0, 1, _tier("fast"), 1, stream_of(x), "wgmma conv")
    torch.cuda.synchronize()
    return out if o16 is None else o16


@pytest.mark.cuda
@pytest.mark.parametrize("B", sorted(WGMMA_BATCHES))
@pytest.mark.parametrize("C,k,dil", WGMMA_CONVS)
def test_wgmma_conv_matches_plain_on_card(cuda_device, C, k, dil, B):
    """The conv with bias, mask and residual at every (C, k, dil) of the route,
    B = 1 and 4: one launch of vk_conv_wgmma (the route's count), zero rows past
    each length, within the fast tier's bound."""
    from vits_tpu_torch.ops.cuda.resblock import conv, wgmma_plan

    args = _wgmma_case(cuda_device, C, k, dil, B, seed=C + k + dil + B)
    x, lens = args[0], args[-1]
    assert wgmma_plan(B, x.shape[1], C, C, k, dil, 132) is not None
    before = conv.wgmma_launches
    got = _wgmma_launch(*args, k, dil, False, 1.0, False)
    assert conv.wgmma_launches == before + 1
    want = _wgmma_reference(*args, k, dil, False, 1.0, False)
    for b, n in enumerate(lens.tolist()):
        assert float(got[b, n:].abs().sum()) == 0.0
    _assert_close(got.cpu(), want.cpu(), atol=TIER_BOUNDS["fast"])


# The epilogue's modes, at B = 4: conv2 of a pair (residual, the carry rounded),
# the last pair of a later resblock (accumulate), the trio's last (accumulate and
# the mean's scale, and out16: the bf16 result).
WGMMA_EPILOGUES = {"residual+round": (False, 1.0, True, False),
                   "accumulate": (True, 1.0, True, False),
                   "accumulate+scale": (True, 1.0 / 3, True, False),
                   "out16": (True, 1.0 / 3, True, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(WGMMA_EPILOGUES))
@pytest.mark.parametrize("C,k", [(256, 11), (128, 3), (64, 7)])
def test_wgmma_conv_epilogue_modes_on_card(cuda_device, C, k, mode):
    accumulate, scale, round_, out16 = WGMMA_EPILOGUES[mode]
    args = _wgmma_case(cuda_device, C, k, 1, 4, seed=C + k, bf16_x=True)
    got = _wgmma_launch(*args, k, 1, accumulate, scale, round_, out16)
    want = _wgmma_reference(*args, k, 1, accumulate, scale, round_)
    if out16:
        assert got.dtype == torch.bfloat16
        want = want.to(torch.bfloat16)
    _assert_close(got.float().cpu(), want.float().cpu(), atol=TIER_BOUNDS["fast"])


@pytest.mark.cuda
@pytest.mark.parametrize("C,T,k,dil", [(256, 2560, 3, 1), (256, 256, 11, 5), (128, 2048, 7, 3)])
def test_wgmma_conv_cluster_split_on_card(cuda_device, C, T, k, dil):
    """Shapes whose plan splits K over a cluster (short rows at B = 1 and 4): the
    partial tiles summed in distributed shared memory."""
    from vits_tpu_torch.ops.cuda import device_sm_count
    from vits_tpu_torch.ops.cuda.resblock import wgmma_plan

    B = 1 if T == 2560 else 4
    rng = np.random.default_rng(T + k)
    lengths = [T - 37] + [T, 0, 100][: B - 1]
    dev = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda_device)  # noqa: E731
    x = dev(_masked(rng, B, T, C, lengths))
    w = dev(rng.standard_normal((k, C, C)) * 0.05).to(torch.bfloat16)
    bias, res = dev(rng.standard_normal(C) * 0.05), dev(_masked(rng, B, T, C, lengths))
    prev = torch.zeros_like(x)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    assert wgmma_plan(B, T, C, C, k, dil, device_sm_count(cuda_device)).split > 1
    args = (x, w, bias, res, prev, lens)
    got = _wgmma_launch(*args, k, dil, False, 1.0, False)
    want = _wgmma_reference(*args, k, dil, False, 1.0, False)
    _assert_close(got.cpu(), want.cpu(), atol=TIER_BOUNDS["fast"])


@pytest.mark.cuda
def test_wgmma_conv_and_trio_repeat_bit_identical_on_card(cuda_device):
    """The same input twice gives the same bits: one conv (a split plan's cluster
    sums its partials in a fixed order, no atomics), and kernel B's whole trio at
    the fast tier on bf16 weights, whose 18 convs all take the route."""
    from vits_tpu_torch.ops.cuda.resblock import conv

    args = _wgmma_case(cuda_device, 256, 11, 5, 1, seed=5)
    a, b = (_wgmma_launch(*args, 11, 5, True, 1.0 / 3, True) for _ in range(2))
    assert torch.equal(a, b)
    rng = np.random.default_rng(6)
    tier = _tier("fast")
    x = torch.tensor(_masked(rng, 1, 2560, 256, [2523]), device=cuda_device).to(torch.bfloat16)
    blocks = _tier_blocks(_blocks(rng, 256), "bfloat16", cuda_device)
    lens = torch.tensor([2523], dtype=torch.int32, device=cuda_device)
    before = conv.wgmma_launches
    a, b = (fused_resblock_trio(x, blocks, slope=SLOPE, lengths=lens, tier=tier)
            for _ in range(2))
    assert conv.wgmma_launches == before + 36
    assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# Kernel C's own Hopper routes at the fast tier on bf16 packs (ops/cuda/stage.py::
# stage_routes): the upsampler (csrc/upsample_wgmma.cu) and the 32-channel pair in
# one launch (csrc/pair_wgmma.cu), each against its plain twin, and the stage on
# both routes against stage_reference. Bound: the fast tier's 0.03 x max(1, |plain|).
# --------------------------------------------------------------------------- #

STAGE_ROUTE_BATCHES = {1: (2523, [2523]), 4: (700, [700, 0, 64, 255])}


def _bf16_rows(device, rng, B, C, T, lengths):
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    x = torch.tensor(_masked(rng, B, T, C, lengths), device=device).to(torch.bfloat16)
    return x, lens


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", sorted(STAGE_ROUTE_BATCHES))
@pytest.mark.parametrize("C_in,C_out", [(128, 64), (64, 32), (32, 16)])
def test_upsample_wgmma_matches_plain_on_card(cuda_device, C_in, C_out, B, dtype):
    """One upsampler launch on Hopper's route (its count), into fp32 or bf16, zero
    rows past each length, within the fast bound of upsample_reference."""
    from vits_tpu_torch.ops.cuda import device_sm_count
    from vits_tpu_torch.ops.cuda.stage import upsample, upsample_plan, upsample_reference

    rng = np.random.default_rng(C_in + B)
    T, lengths = STAGE_ROUTE_BATCHES[B]
    x, lens = _bf16_rows(cuda_device, rng, B, C_in, T, lengths)
    dev = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda_device)  # noqa: E731
    w = dev(rng.standard_normal((4, C_in, C_out)) * 0.05).to(torch.bfloat16)
    bias = dev(rng.standard_normal(C_out) * 0.1)
    plan = upsample_plan(B, T, C_in, C_out, 4, 2, 1, device_sm_count(cuda_device))
    up = torch.empty((B, 2 * T, C_out), dtype=getattr(torch, dtype), device=cuda_device)
    before = upsample.wgmma_launches
    kw = dict(stride=2, up_padding=1, slope=SLOPE, tier=_tier("fast"))
    upsample(x, up, w, bias, lens, up_fmt=1, up_scale=None, plan=plan, **kw)
    torch.cuda.synchronize()
    assert upsample.wgmma_launches == before + 1
    for b, n in enumerate(lengths):
        assert float(up[b, 2 * n:].float().abs().sum()) == 0.0
    want = upsample_reference(x, w, bias, lengths=lens, **kw)
    _assert_close(up.float().cpu(), want.cpu(), atol=TIER_BOUNDS["fast"])


PAIR_MODES = {"bf16 out": (False, 1.0, True), "accumulate": (True, 1.0, False),
              "accumulate+scale": (True, 1.0 / 3, False), "out16": (True, 1.0 / 3, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(PAIR_MODES))
@pytest.mark.parametrize("k,dil", [(k, d) for k in (3, 7, 11) for d in (1, 3, 5)])
def test_pair_wgmma_matches_plain_on_card(cuda_device, k, dil, mode):
    """One pair in one launch of the pair route (its count) at B = 4 (a length-0
    row, lengths at tile edges), each epilogue mode, within the fast bound of
    pair_reference."""
    from vits_tpu_torch.ops.cuda import device_sm_count, stream_of
    from vits_tpu_torch.ops.cuda.resblock import conv, pair, pair_plan, pair_reference

    accumulate, scale, into16 = PAIR_MODES[mode]
    rng = np.random.default_rng(k * 10 + dil)
    T, lengths = STAGE_ROUTE_BATCHES[4]
    x, lens = _bf16_rows(cuda_device, rng, 4, 32, T, lengths)
    dev = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda_device)  # noqa: E731
    w1, w2 = (dev(rng.standard_normal((k, 32, 32)) * 0.05).to(torch.bfloat16) for _ in range(2))
    b1, b2 = (dev(rng.standard_normal(32) * 0.05) for _ in range(2))
    prev = dev(rng.standard_normal((4, T, 32)))
    plan = pair_plan(4, T, 32, k, dil, device_sm_count(cuda_device))
    out32 = prev.clone() if accumulate else None
    out16 = torch.empty_like(x) if into16 else None
    before = conv.pair_launches
    pair(x, out32, out16, w1, b1, w2, b2, lens, k, dil, SLOPE, int(accumulate), scale, plan,
         _tier("fast"), stream_of(x))
    torch.cuda.synchronize()
    assert conv.pair_launches == before + 1
    got = (out16 if into16 else out32).float()
    want = pair_reference(x, w1, b1, w2, b2, lens, k, dil, SLOPE, _tier("fast"),
                          prev if accumulate else None, scale)
    if not accumulate:
        for b, n in enumerate(lengths):
            assert float(got[b, n:].abs().sum()) == 0.0
    _assert_close(got.cpu(), want.cpu(), atol=TIER_BOUNDS["fast"])


@pytest.mark.cuda
@pytest.mark.parametrize("final", [False, True])
def test_stage_on_hopper_routes_matches_plain_on_card(cuda_device, final):
    """fused_stage at 64->32 (with conv_post, and chained into bf16) at the fast tier
    on bf16 packs: one upsampler launch on Hopper's route, nine pair launches, no
    mma.sync conv, within the fast bound of stage_reference."""
    from vits_tpu_torch.ops.cuda.resblock import conv
    from vits_tpu_torch.ops.cuda.stage import fused_stage, stage_reference, upsample

    rng = np.random.default_rng(21)
    T, lengths = STAGE_ROUTE_BATCHES[4]
    x, lens = _bf16_rows(cuda_device, rng, 4, 64, T, lengths)
    dev = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda_device)  # noqa: E731
    blocks = _to(_blocks(rng, 32, ks=(3, 7, 11), scale=0.05),
                 lambda a: dev(a).to(torch.bfloat16) if a.ndim == 4 else dev(a))
    kw = dict(stride=2, up_padding=1, slope=SLOPE, lengths=lens, tier=_tier("fast"),
              chain=not final, final_conv=(dev(rng.standard_normal((7, 32, 1)) * 0.3).to(
                  torch.bfloat16), 3) if final else None)
    args = (x, dev(rng.standard_normal((4, 64, 32)) * 0.05).to(torch.bfloat16),
            dev(rng.standard_normal(32) * 0.1), blocks)
    counts = (upsample.wgmma_launches, conv.pair_launches, conv.mma_sync_launches)
    got = fused_stage(*args, **kw)
    torch.cuda.synchronize()
    assert (upsample.wgmma_launches - counts[0], conv.pair_launches - counts[1],
            conv.mma_sync_launches - counts[2]) == (1, 9, 0)
    want = stage_reference(*args, **kw)
    assert got.dtype == want.dtype
    _assert_close(got.float().cpu(), want.float().cpu(), atol=TIER_BOUNDS["fast"])
