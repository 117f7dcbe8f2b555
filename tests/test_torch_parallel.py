"""The port's data axis (``vits_tpu_torch/parallel``) in one process.

``pad_rows`` against the JAX loop's padding rule (``vits_tpu/train/loop.py``:
dummy rows of one valid token and ``max(segment_frames, 8)`` silent frames),
``rank_rows``' interleaving of microbatches, the coalesced collectives on a
one-rank gloo group, and the start-up helpers. The two-rank behaviour is in
``test_torch_train_dp*.py``.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tests.test_torch_dp_worker import free_port
from vits_tpu_torch.parallel import distributed
from vits_tpu_torch.parallel.mesh import (
    DataParallel,
    all_reduce_,
    broadcast_,
    data_axis,
    microbatch_rows,
    pad_rows,
    rank_rows,
    zero1_owners,
)
from vits_tpu_torch.train.step import TrainBatch


def _batch(B, T=5, S=12, up=4, speakers=False):
    rng = np.random.default_rng(B)
    return TrainBatch(
        input_ids=rng.integers(1, 9, (B, T)).astype(np.int32),
        token_mask=np.ones((B, T), np.float32),
        spectrogram=rng.standard_normal((B, S, 3)).astype(np.float32),
        frame_mask=np.ones((B, S), np.float32),
        audio=rng.standard_normal((B, S * up)).astype(np.float32),
        speaker_id=np.arange(B, dtype=np.int32) + 1 if speakers else None,
    )


@pytest.mark.parametrize("B,world,segment", [(3, 2, 8), (5, 4, 4), (1, 4, 10), (6, 3, 8)])
@pytest.mark.parametrize("speakers", [False, True])
def test_pad_rows_pads_to_the_world_with_dummy_rows(B, world, segment, speakers):
    batch = _batch(B, speakers=speakers)
    padded = pad_rows(batch, world, segment)
    target = -(-B // world) * world
    assert padded.input_ids.shape[0] == target and padded.input_ids.dtype == np.int32
    for name, x in padded._asdict().items():
        if x is None:
            assert not speakers and name == "speaker_id"
            continue
        assert x.shape[0] == target, name
        np.testing.assert_array_equal(x[:B], getattr(batch, name), err_msg=name)
        if name not in ("token_mask", "frame_mask"):
            assert not x[B:].any(), name  # zero ids, spectrogram, audio and speaker
    extra = target - B
    np.testing.assert_array_equal(padded.token_mask[B:].sum(axis=1), np.ones(extra))
    assert (padded.token_mask[B:, 0] == 1).all()
    frames = min(max(segment, 8), batch.frame_mask.shape[1])
    np.testing.assert_array_equal(padded.frame_mask[B:].sum(axis=1), np.full(extra, frames))


def test_pad_rows_leaves_a_full_batch_alone():
    batch = _batch(4)
    assert pad_rows(batch, 2, 8) is batch


# (4, 4, 2), (6, 2, 2) and (12, 4, 3): microbatches that do not divide over the
# ranks (shares differ by one row; at (4, 4, 2) two ranks hold none), as JAX runs them
@pytest.mark.parametrize("B,world,accum", [(4, 2, 1), (4, 2, 2), (8, 2, 2), (12, 3, 2),
                                            (8, 4, 1), (6, 1, 3), (4, 4, 2), (6, 2, 2),
                                            (12, 4, 3)])
def test_rank_rows_hold_a_share_of_every_microbatch(B, world, accum):
    m = B // accum
    held = [rank_rows(B, world, r, accum) for r in range(world)]
    assert sorted(np.concatenate(held).tolist()) == list(range(B))  # disjoint, covering
    for r, rows in enumerate(held):
        runs = microbatch_rows(B, world, r, accum)
        np.testing.assert_array_equal(np.concatenate(runs), rows)
        for i, run in enumerate(runs):  # the rank's i-th run of rows is its share of microbatch i
            assert ((run >= i * m) & (run < (i + 1) * m)).all()
            np.testing.assert_array_equal(run, i * m + np.arange(r * m // world,
                                                                 (r + 1) * m // world))
            assert m // world <= len(run) <= -(-m // world)  # shares differ by one row at most


# a batch that does not divide by grad_accum, or over the ranks (before pad_rows): JAX
# refuses these too
@pytest.mark.parametrize("B,world,accum", [(4, 3, 1), (6, 4, 3), (5, 1, 2)])
def test_rank_rows_refuse_indivisible_microbatches(B, world, accum):
    with pytest.raises(ValueError):
        rank_rows(B, world, 0, accum)


def test_zero1_owners_deterministic_and_largest_first():
    numels = [10, 300, 20, 300, 5, 100]
    owners = zero1_owners(numels, 2)
    assert owners == zero1_owners(numels, 2)
    assert owners[1] == 0 and owners[3] == 1  # the two largest on different ranks
    assert zero1_owners(numels, 1) == [0] * len(numels)


def test_helpers_without_a_process_group():
    assert not dist.is_initialized()
    assert distributed.is_primary() and distributed.process_index() == 0
    assert distributed.process_count() == 1 and data_axis() is None
    assert distributed.local_device("cpu") == torch.device("cpu")


def test_local_device_is_the_local_rank_card(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert distributed.local_device("cuda") == torch.device("cuda", 3)
    monkeypatch.delenv("LOCAL_RANK")
    assert distributed.local_device("cuda") == torch.device("cuda", 0)


def test_initialize_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize("localhost:1", 1, 0, device="cuda")
    assert not dist.is_initialized()


def test_one_rank_group_from_torchrun_environment(monkeypatch):
    """initialize() with no address reads torchrun's variables; gloo for the CPU;
    each collective is one call over a flat buffer, and a world of one leaves
    every value as it was."""
    for name, value in (("RANK", "0"), ("WORLD_SIZE", "1"), ("MASTER_ADDR", "localhost"),
                        ("MASTER_PORT", str(free_port()))):
        monkeypatch.setenv(name, value)
    distributed.initialize(heartbeat_timeout_seconds=60, device="cpu")
    try:
        assert dist.get_backend() == "gloo"
        assert data_axis() == DataParallel(1, 0) and distributed.is_primary()
        calls = []
        for name in ("all_reduce", "broadcast"):
            original = getattr(dist, name)
            monkeypatch.setattr(dist, name, lambda t, *a, _f=original, _n=name, **k: (
                calls.append((_n, t.numel())), _f(t, *a, **k))[1])
        tensors = [torch.randn(3, 4), torch.randn(5), torch.randn(2, 2, 2)]
        before = [t.clone() for t in tensors]
        all_reduce_(tensors)
        broadcast_(tensors, 0)
        assert calls == [("all_reduce", 25), ("broadcast", 25)]
        for t, b in zip(tensors, before):
            assert torch.equal(t, b)
    finally:
        dist.destroy_process_group()
