"""The port's training modules against their JAX counterparts.

Same parameters (``tiny_bundle``; the discriminator from
``init_discriminator_params`` carried through ``from_jax_params``), same
seeded numpy inputs, CPU on both sides. Tolerance: fp32 summation-order
noise, atol 1e-5 relative to max(1, |ref|), except where stated. The
monotonic alignment must be equal, padded frames included; the optimizer and
EMA run on identical gradients (rtol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vits_tpu.io.params import ParamView as JaxParamView
from vits_tpu.models import discriminator as jax_disc
from vits_tpu.models import duration as jax_duration
from vits_tpu.models import flow as jax_flow
from vits_tpu.models import posterior as jax_posterior
from vits_tpu.ops import align as jax_align
from vits_tpu.train import losses as jax_losses
from vits_tpu.train import schedule as jax_schedule
from vits_tpu.train.checkpoint import _load_flat
from vits_tpu.utils import mel as jax_mel
from vits_tpu_torch.io.params import ParamView, from_jax_params, to_jax_params
from vits_tpu_torch.models import discriminator, duration, flow, posterior
from vits_tpu_torch.ops import align
from vits_tpu_torch.train import losses, schedule
from vits_tpu_torch.train.checkpoint import save_checkpoint
from vits_tpu_torch.utils import mel

torch.set_num_threads(2)

ATOL = 1e-5


def _assert_close(got, want, atol=ATOL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0, err_msg=what)


@pytest.fixture(scope="module")
def bundle(tiny_bundle):
    config, params = tiny_bundle
    return config, params, from_jax_params(params, "cpu")


def _mask(lengths, T):
    return (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.tensor(a) for a in arrays]


def test_flow_forward_matches_jax(bundle):
    config, params, tparams = bundle
    rng = np.random.default_rng(0)
    z = rng.standard_normal((2, 19, config.flow_size)).astype(np.float32)
    (jz, jm), (tz, tm) = _both(z, _mask([19, 9], 19)[..., None])
    want, want_ld = jax_flow.residual_coupling_block(JaxParamView(params), config, jz, jm,
                                                     reverse=False)
    got, got_ld = flow.residual_coupling_forward(ParamView(tparams), config, tz, tm)
    _assert_close(got, want)
    _assert_close(got_ld, want_ld)


def test_posterior_matches_jax(bundle):
    config, params, tparams = bundle
    rng = np.random.default_rng(1)
    spec = rng.standard_normal((2, 17, config.spectrogram_bins)).astype(np.float32)
    noise = rng.standard_normal((2, 17, config.flow_size)).astype(np.float32)
    (js, jm, jn), (ts, tm, tn) = _both(spec, _mask([17, 10], 17)[..., None], noise)
    want = jax_posterior.posterior_encoder(JaxParamView(params), config, js, jm, jn)
    got = posterior.posterior_encoder(ParamView(tparams), config, ts, tm, tn)
    for g, w in zip(got, want):
        _assert_close(g, w)


def test_sdp_nll_matches_jax(bundle):
    config, params, tparams = bundle
    rng = np.random.default_rng(2)
    hidden = rng.standard_normal((2, 11, config.hidden_size)).astype(np.float32)
    mask3 = _mask([11, 6], 11)[..., None]
    durations = (rng.integers(1, 5, (2, 11, 1)) * mask3).astype(np.float32)
    noise = rng.standard_normal((2, 11, 2)).astype(np.float32)
    (jh, jm, jd, jn), (th, tm, td, tn) = _both(hidden, mask3, durations, noise)
    want = jax_duration.stochastic_duration_predictor_nll(JaxParamView(params), config, jh, jm,
                                                          jd, jn)
    got = duration.stochastic_duration_predictor_nll(ParamView(tparams), config, th, tm, td, tn)
    _assert_close(got, want)


def test_alignment_matches_jax():
    """prior_log_likelihood at 1e-5; MAS alignments equal, padded frames and tokens included."""
    rng = np.random.default_rng(3)
    B, S, T, C = 3, 29, 9, 6
    z = rng.standard_normal((B, S, C)).astype(np.float32)
    m = rng.standard_normal((B, T, C)).astype(np.float32)
    logs = (rng.standard_normal((B, T, C)) * 0.3).astype(np.float32)
    (jz, jmu, jls), (tz, tmu, tls) = _both(z, m, logs)
    want_ll = jax_align.prior_log_likelihood(jz, jmu, jls)
    got_ll = align.prior_log_likelihood(tz, tmu, tls)
    _assert_close(got_ll, want_ll)
    fmask, tmask = _mask([29, 17, 12], S), _mask([9, 5, 1], T)
    ll = np.array(want_ll)
    ll[1] = -1.0  # every path ties: the >= break toward the diagonal move decides
    want = jax_align.monotonic_align(jnp.asarray(ll), jnp.asarray(fmask), jnp.asarray(tmask))
    got = align.monotonic_align(torch.tensor(ll), torch.tensor(fmask), torch.tensor(tmask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.sum(dim=(1, 2)).numpy(), fmask.sum(axis=1))


def test_log_mel_matches_jax():
    audio = (np.random.default_rng(4).standard_normal((2, 128)) * 0.3).astype(np.float32)
    kwargs = dict(n_fft=256, hop_length=64, n_mels=20)  # pads past the length: repeated reflect
    _assert_close(mel.log_mel_spectrogram(torch.tensor(audio), **kwargs),
                  jax_mel.log_mel_spectrogram(jnp.asarray(audio), **kwargs))
    long = (np.random.default_rng(5).standard_normal((1, 4096)) * 0.3).astype(np.float32)
    _assert_close(mel.log_mel_spectrogram(torch.tensor(long)),
                  jax_mel.log_mel_spectrogram(jnp.asarray(long)))


@pytest.fixture(scope="module")
def disc():
    numpy_params = discriminator.init_discriminator_params(0)
    return numpy_params, from_jax_params(numpy_params, "cpu")


def test_discriminator_matches_jax(disc):
    numpy_params, tparams = disc
    jax_params = jax_disc.init_discriminator_params(0)
    assert list(numpy_params) == list(jax_params)
    for k, v in jax_params.items():
        np.testing.assert_array_equal(numpy_params[k], v)
    audio = (np.random.default_rng(6).standard_normal((2, 301)) * 0.3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want_logits, want_feats = jax_disc.discriminate(
            {k: jnp.asarray(v) for k, v in jax_params.items()}, jnp.asarray(audio))
    got_logits, got_feats = discriminator.discriminate(tparams, torch.tensor(audio))
    for g, w in zip(got_logits, want_logits):
        _assert_close(g, w)
    for gs, ws in zip(got_feats, want_feats):
        for g, w in zip(gs, ws):
            _assert_close(g, w)


def test_losses_match_jax():
    rng = np.random.default_rng(7)
    arrays = [rng.standard_normal((2, 13, 4)).astype(np.float32) for _ in range(4)]
    fmask = _mask([13, 7], 13)
    (jz, jq, jm, jp, jf), (tz, tq, tm, tp, tf) = _both(*arrays, fmask)
    _assert_close(losses.kl_divergence(tz, tq, tm, tp, tf),
                  jax_losses.kl_divergence(jz, jq, jm, jp, jf))
    logits = [rng.standard_normal((2, n)).astype(np.float32) for n in (5, 9)]
    feats = [[rng.standard_normal((2, n, 3)).astype(np.float32) for n in (4, 6)]
             for _ in range(2)]
    jl, tl = _both(*logits)
    _assert_close(losses.generator_adversarial_loss(tl), jax_losses.generator_adversarial_loss(jl))
    _assert_close(losses.discriminator_loss(tl, tl[::-1]),
                  jax_losses.discriminator_loss(jl, jl[::-1]))
    jfeats = [[jnp.asarray(a) for a in f] for f in feats]
    tfeats = [[torch.tensor(a) for a in f] for f in feats]
    _assert_close(losses.feature_matching_loss(tfeats, tfeats[::-1]),
                  jax_losses.feature_matching_loss(jfeats, jfeats[::-1]))
    u = np.asarray([0.0, 0.999], np.float32)
    lengths = np.asarray([40, 20], np.int32)
    want_starts = np.asarray((u * (np.maximum(lengths - 8, 0) + 1)).astype(np.int32))
    starts = losses.random_segment_starts(torch.tensor(u), torch.tensor(lengths), 8)
    np.testing.assert_array_equal(starts.numpy(), want_starts)
    x = rng.standard_normal((2, 40, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        losses.slice_segments(torch.tensor(x), starts, 8).numpy(),
        np.asarray(jax_losses.slice_segments(jnp.asarray(x), jnp.asarray(want_starts), 8)))


def test_optimizer_and_ema_match_optax():
    """Three steps on identical gradients, clipping active on one, vs optax (rtol 1e-6)."""
    rng = np.random.default_rng(8)
    params = {f"p{i}": rng.standard_normal(s).astype(np.float32)
              for i, s in enumerate([(3, 4), (5,), (2, 2, 2)])}
    grads = [{k: (rng.standard_normal(v.shape) * scale).astype(np.float32)
              for k, v in params.items()} for scale in (1e-3, 400.0, 0.5)]
    opt = jax_schedule.vits_optimizer(2e-4, steps_per_epoch=7)
    ema = jax_schedule.ParamEMA()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state, jema = opt.init(jp), ema.init(jp)
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    topt = schedule.vits_optimizer(tparams, 2e-4, steps_per_epoch=7)
    tema_obj = schedule.ParamEMA()
    tema = tema_obj.init(tparams)
    for i, g in enumerate(grads):
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        jema = ema.update(jema, jp, i)
        for k, p in tparams.items():
            p.grad = torch.tensor(g[k])
        topt.step()
        tema_obj.update(tema, tparams, i)
        for k in params:
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=0, err_msg=f"step {i} {k}")
            np.testing.assert_allclose(tema[k].numpy(), np.asarray(jema[k]), rtol=1e-6,
                                       atol=0, err_msg=f"ema step {i} {k}")


def test_params_round_trip_and_checkpoint_loads_in_jax(bundle, tmp_path):
    _, params, tparams = bundle
    back = to_jax_params(tparams)
    assert list(back) == list(params)
    for k, v in params.items():
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], v)
    ckpt = save_checkpoint(str(tmp_path), 7, tparams)
    loaded = _load_flat(f"{ckpt}/gen_params.npz")
    assert {k: v.shape for k, v in loaded.items()} == {k: v.shape for k, v in params.items()}
    for k, v in params.items():
        np.testing.assert_array_equal(loaded[k], v)


def test_dataset_batches_equal_jax(bundle, tmp_path):
    from vits_tpu.text.tokenizer import VitsTokenizer
    from vits_tpu.train.data import VitsDataset as JaxDataset
    from vits_tpu.train.synthetic import corpus_vocab, generate_micro_corpus
    from vits_tpu_torch.train.data import VitsDataset

    config = bundle[0]
    generate_micro_corpus(str(tmp_path), n_utts=5, words_range=(1, 2))
    tokenizer = VitsTokenizer(vocab=corpus_vocab(), pad_token="_", unk_token="?")
    want = JaxDataset(str(tmp_path), tokenizer, config, max_frames=120, use_native=False)
    got = VitsDataset(str(tmp_path), tokenizer, config, max_frames=120, use_native=False)
    pairs = zip(got.batches(2, np.random.default_rng(3), epochs=1),
                want.batches(2, np.random.default_rng(3), epochs=1))
    n = 0
    for g, w in pairs:
        for name in w._fields:
            if getattr(w, name) is not None:
                np.testing.assert_array_equal(getattr(g, name), getattr(w, name), err_msg=name)
        n += 1
    assert n == 3


def test_prefetcher_reraises_producer_error():
    from vits_tpu_torch.train.data import Prefetcher

    def produce():
        yield 1
        raise OSError("disk gone")

    with Prefetcher(produce()) as batches:
        assert next(batches) == 1
        with pytest.raises(RuntimeError, match="producer failed") as err:
            next(batches)
        assert isinstance(err.value.__cause__, OSError)
        with pytest.raises(StopIteration):
            next(batches)
    assert not batches._thread.is_alive()
