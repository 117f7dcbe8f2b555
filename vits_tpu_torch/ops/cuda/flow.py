"""Kernel 6: the reverse residual-coupling flow, one host call per flow.

Replaces ``vits_tpu/ops/pallas/flow.py::fused_flow``: the prior latents go
back through the ``n_flows`` mean-only couplings (flow n-1 first, a channel
flip before each), each a 1x1 conv_pre, a WaveNet of ``nl`` gated k=5 layers
with per-layer speaker conditioning, and a 1x1 conv_post whose output is
subtracted from the other half; rows at and past each row's length are zero
after every step. The CUDA kernel is ``vits_tpu_torch/csrc/flow.cu``.

The TPU kernel runs grid ``(B, n_flows)`` with the whole sequence resident in
VMEM and the couplings in order. Here the flow is one tensor-core product per
step of each coupling (conv_pre, each layer's gate and res/skip, conv_post)
over all frames of the batch, the step's elementwise work in its epilogue,
with the WaveNet state in three (B, T, hidden) buffers; the launches are
captured once per (B, T) shape into a CUDA graph (:class:`FlowWorkspace`), so
a call is one C call. The weights are packed once per parameter set
(:func:`pack_flow_weights`, the JAX function of that name with the gate's and
res/skip's column pairs interleaved), the flips folded in as JAX folds them;
the engine keeps the pack (``Synthesizer``), so a call's Python work does not
grow with the number of weights. The per-(row, coupling, layer) speaker
vectors are the ``cond_layer`` 1x1 convs of the embedding: one small kernel
on the pack's stacked cond weights before the products (:func:`pack_flow_cond`
computes the same vectors conv by conv, as JAX computes them outside its
``pallas_call``). The plain PyTorch twin is :func:`flow_reference`: the
module's own math; :func:`flow_packed_reference` runs the kernel's arithmetic
on the packed weights, at a precision tier (``ops/tiers.py``: the JAX kernel's
``precision``, every product's operands rounded as the tier rounds them; the
values stay fp32). The captured graph bakes its tier in: a pack keeps one
workspace per (B, T, speakers, tier, dtype).

bf16 serving (``Tier.bf16_compute``): x, the speaker embedding and the output
are bf16, as the JAX kernel's are at ``compute_dtype="bfloat16"``; the pack
holds the bf16 parameters as fp32 (JAX's ``pack_flow_weights`` casts them so),
the graph widens the inputs into its fp32 workspace, rounds the speaker
vectors where JAX's bf16 ``cond_layer`` conv rounds them, stages fp32 and
rounds the result to bf16 (:func:`flow_compute16_reference` is the twin).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
import weakref
from collections import OrderedDict

import torch

from vits_tpu_torch.config import VitsConfig
from vits_tpu_torch.io.params import ParamView
from vits_tpu_torch.models.flow import residual_coupling_block
from vits_tpu_torch.ops.conv import conv1d
from vits_tpu_torch.ops.tiers import EXACT, EXACT_TIER, Tier, tier_conv1d, tier_matmul
from vits_tpu_torch.ops.cuda import (
    check,
    count_launch,
    cuda_lengths,
    device_sm_count,
    library,
    no_autograd,
    on_cuda,
    on_device,
    stream_of,
)
from vits_tpu_torch.ops.cuda.resblock import CONV_TILES, conv_plan, length_mask

# The packed arrays, in the order vk_flow_capture takes their pointers.
PACK_NAMES = ("w_pre", "b_pre", "w_gate", "b_gate", "w_rs", "b_rs", "w_post", "b_post")


def flow_steps(config: VitsConfig) -> list[tuple[int, bool]]:
    """The reverse flow's execution order: ``(coupling index, flipped)`` per step.

    Step s runs coupling n-1-s after s+1 flips. In the input's channel order
    an odd number of flips makes the coupling read the second half reversed
    and subtract its reversed mean from the first half (the JAX kernel's type
    A steps, s even); an even number reads the first half and updates the
    second (type B). With n even the output is back in the input's order.
    """
    n = config.prior_encoder_num_flows
    return [(n - 1 - s, s % 2 == 0) for s in range(n)]


def pack_flow_cond(params: ParamView, config: VitsConfig,
                   speaker_embeddings: torch.Tensor) -> torch.Tensor:
    """(B, 1, speaker_emb) -> (B, n_flows, nl, 2*hidden) WaveNet cond, in execution order."""
    nl, hidden = config.prior_encoder_num_wavenet_layers, config.hidden_size
    p = params.sub("flow")
    per_step = []
    for i, _ in flow_steps(config):
        wn = p.sub(f"flows.{i}.wavenet")
        c = conv1d(speaker_embeddings, wn["cond_layer.weight"], wn["cond_layer.bias"])
        per_step.append(c.reshape(c.shape[0], nl, 2 * hidden))
    return torch.stack(per_step, dim=1).contiguous()


def flow_reference(
    x: torch.Tensor,  # (B, T, flow_size) prior latents
    params: ParamView,
    config: VitsConfig,
    *,
    lengths: torch.Tensor | None = None,  # (B,) valid frames
    speaker_embeddings: torch.Tensor | None = None,  # (B, 1, speaker_emb)
) -> torch.Tensor:
    """Plain PyTorch: the reverse coupling stack, zero at and past each length."""
    mask = length_mask(lengths, x.shape[1], x.dtype)
    if mask is None:
        mask = x.new_ones((*x.shape[:2], 1))
    return residual_coupling_block(params, config, x, mask, speaker_embeddings) * mask


def interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., m), (..., m) -> (..., 2m): a's column j at 2j, b's at 2j + 1."""
    return torch.stack((a, b), dim=-1).flatten(-2)


class FlowPack:
    """The flow's weights in execution order, one contiguous fp32 buffer.

    ``arrays`` maps :data:`PACK_NAMES` (and, for a multi-speaker model,
    ``w_cond`` (speaker_emb, n*nl*2*hidden) and ``b_cond``) to views of
    ``buffer``.
    On a CUDA device each (B, T) shape the kernel runs gets a
    :class:`FlowWorkspace` (:meth:`workspace`): persistent buffers and the
    flow's launches captured over them once. The pack keeps every workspace
    made or used under :meth:`keeping` (``Synthesizer.warmup``'s shapes) and
    the most recent :data:`WORKSPACES` others. The workspace dict is guarded by
    a lock: a server calls the flow from several threads.
    """

    def __init__(self, buffer: torch.Tensor, arrays: dict[str, torch.Tensor]):
        self.buffer, self.arrays = buffer, arrays
        self.pointers = (ctypes.c_void_p * (len(PACK_NAMES) + 2))(
            *(arrays[name].data_ptr() for name in PACK_NAMES),
            *(arrays[name].data_ptr() if name in arrays else None
              for name in ("w_cond", "b_cond")))
        self._workspaces: OrderedDict = OrderedDict()
        self._kept: set = set()
        self._keeping = False
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def keeping(self):
        """Keep every workspace that the calls inside make or use, for good."""
        self._keeping = True
        try:
            yield self
        finally:
            self._keeping = False

    def workspace(self, config: VitsConfig, B: int, T: int, speakers: bool,
                  mode: int = EXACT, io16: bool = False) -> "FlowWorkspace":
        key, extra = (B, T, speakers, mode), {}
        if io16:  # bf16 serving's graphs apart from the fp32 ones
            key, extra = (*key, True), {"io16": True}
        with self._lock:
            ws = (self._workspaces.pop(key, None)
                  or FlowWorkspace(self, config, B, T, speakers, mode, **extra))
            self._workspaces[key] = ws
            if self._keeping:
                self._kept.add(key)
            while len(self._workspaces) > WORKSPACES + len(self._kept):
                del self._workspaces[next(k for k in self._workspaces if k not in self._kept)]
        return ws


# (B, T, speakers, tier, dtype) workspaces a pack keeps besides those made under
# FlowPack.keeping.
WORKSPACES = 8


class FlowWorkspace:
    """The buffers of one (B, T) flow and its launches captured as a CUDA graph.

    ``vk_flow_capture`` records the cond kernel and the 40 products over these
    buffers once; a call then copies its input, lengths and embedding in,
    replays the graph and copies the result out (``vk_flow_run``): five
    operations on the stream, from one C call. Calls that share a workspace
    must run on one stream; :attr:`lock` is held across each call's enqueue
    (:func:`fused_flow`), so the five operations of two threads' calls do not
    interleave on it. With ``io16`` (bf16 serving) a call's input, embedding
    and output pass through the bf16 buffers ``x16`` and ``emb16``, which the
    graph widens and narrows.
    """

    def __init__(self, packed: FlowPack, config: VitsConfig, B: int, T: int, speakers: bool,
                 mode: int = EXACT, io16: bool = False):
        half, hidden = config.flow_size // 2, config.hidden_size
        nl, k, n = (config.prior_encoder_num_wavenet_layers, config.wavenet_kernel_size,
                    config.prior_encoder_num_flows)
        weights = packed.arrays["w_pre"]
        new = functools.partial(torch.empty, device=weights.device, dtype=torch.float32)
        self.x = new((B, T, 2 * half))
        self.lens = torch.empty((B,), dtype=torch.int32, device=weights.device)
        self.full = torch.full((B,), T, dtype=torch.int32, device=weights.device)
        self.scratch = new((3, B, T, hidden))  # h, acts, skip
        self.emb_size = packed.arrays["w_cond"].shape[0] if speakers else 0
        self.emb = new((B, self.emb_size)) if speakers else None
        self.cond = new((B, n * nl * 2 * hidden)) if speakers else None
        new16 = functools.partial(torch.empty, device=weights.device, dtype=torch.bfloat16)
        self.x16 = new16((B, T, 2 * half)) if io16 else None
        self.emb16 = new16((B, self.emb_size)) if io16 and speakers else None
        self.lock = threading.Lock()
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        lib = library()
        self.exec = ctypes.c_void_p()
        with on_device(weights):
            check(lib.vk_flow_capture(
                self.x.data_ptr(), self.lens.data_ptr(), ptr(self.emb), ptr(self.cond),
                self.emb_size, packed.pointers,
                flow_plan(B, T, half, hidden, k, device_sm_count(weights.device)),
                *(t.data_ptr() for t in self.scratch), B, T, half, hidden, nl, k, n, mode,
                ptr(self.x16), ptr(self.emb16), ctypes.byref(self.exec)), "flow kernels (capture)")
        weakref.finalize(self, lib.vk_graph_destroy, self.exec.value)


def pack_flow_weights(params: ParamView, config: VitsConfig) -> FlowPack:
    """Stack the flow's weights in execution order with the flips folded in.

    As ``vits_tpu/ops/pallas/flow.py::pack_flow_weights``: step s runs
    coupling n-1-s; on its flipped steps (s even) conv_pre's rows and
    conv_post's columns and bias are reversed, so the step reads the second
    half and updates the first with no permutation. The gate's (tanh, sigmoid)
    and res/skip's (res, skip) column halves are interleaved (:func:`interleave`:
    JAX's ``wt[..., j]`` is ``w_gate[..., 2j]``, ``ws[..., j]`` is
    ``w_gate[..., 2j + 1]``; ``wres``/``wskip`` likewise in ``w_rs``), the
    last layer's res columns zero as in JAX's pack. Shapes: w_pre (n, half,
    hidden), b_pre (n, hidden), w_gate (n, nl, k, hidden, 2*hidden), b_gate
    (n, nl, 2*hidden), w_rs (n, nl, hidden, 2*hidden), b_rs (n, nl, 2*hidden),
    w_post (n, hidden, half), b_post (n, half).
    """
    half, hidden = config.flow_size // 2, config.hidden_size
    nl, k = config.prior_encoder_num_wavenet_layers, config.wavenet_kernel_size
    p = params.sub("flow")

    def weight(view: ParamView, name: str, shape: tuple) -> torch.Tensor:
        t = view[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"flow kernel: {name} {tuple(t.shape)} != {shape}")
        return t

    stacks: dict[str, list] = {name: [] for name in PACK_NAMES}
    conds = []
    for i, flipped in flow_steps(config):
        f = p.sub(f"flows.{i}")
        w_pre = weight(f, "conv_pre.weight", (1, half, hidden))[0]
        w_post = weight(f, "conv_post.weight", (1, hidden, half))[0]
        b_post = weight(f, "conv_post.bias", (half,))
        if flipped:
            w_pre, w_post, b_post = w_pre.flip(0), w_post.flip(1), b_post.flip(0)
        stacks["w_pre"].append(w_pre)
        stacks["b_pre"].append(weight(f, "conv_pre.bias", (hidden,)))
        stacks["w_post"].append(w_post)
        stacks["b_post"].append(b_post)
        wn = f.sub("wavenet")
        gw, gb, rw, rb = [], [], [], []
        for l in range(nl):
            w_in = weight(wn, f"in_layers.{l}.weight", (k, hidden, 2 * hidden))
            b_in = weight(wn, f"in_layers.{l}.bias", (2 * hidden,))
            gw.append(interleave(w_in[..., :hidden], w_in[..., hidden:]))
            gb.append(interleave(b_in[:hidden], b_in[hidden:]))
            rs = 2 * hidden if l < nl - 1 else hidden
            w_rs = weight(wn, f"res_skip_layers.{l}.weight", (1, hidden, rs))[0]
            b_rs = weight(wn, f"res_skip_layers.{l}.bias", (rs,))
            if l < nl - 1:
                rw.append(interleave(w_rs[:, :hidden], w_rs[:, hidden:]))
                rb.append(interleave(b_rs[:hidden], b_rs[hidden:]))
            else:  # all skip
                rw.append(interleave(torch.zeros_like(w_rs), w_rs))
                rb.append(interleave(torch.zeros_like(b_rs), b_rs))
        stacks["w_gate"].append(torch.stack(gw))
        stacks["b_gate"].append(torch.stack(gb))
        stacks["w_rs"].append(torch.stack(rw))
        stacks["b_rs"].append(torch.stack(rb))
        if "cond_layer.weight" in wn:
            conds.append((wn["cond_layer.weight"][0], wn["cond_layer.bias"]))
    stacked = {name: torch.stack(v).float() for name, v in stacks.items()}
    if conds:
        stacked["w_cond"] = torch.cat([w for w, _ in conds], dim=1).float()
        stacked["b_cond"] = torch.cat([b for _, b in conds]).float()
    # one buffer, each array at a 16-byte aligned offset
    flat = torch.cat([t.reshape(-1) for t in stacked.values()])
    arrays, pos = {}, 0
    for name, t in stacked.items():
        arrays[name] = flat[pos: pos + t.numel()].view(t.shape)
        pos += t.numel()
    for name, t in arrays.items():
        if t.data_ptr() % 16:
            raise ValueError(f"flow kernel: packed {name} is not 16-byte aligned "
                             f"(flow_size // 2 and hidden_size must be multiples of 4)")
    return FlowPack(flat, arrays)


def flow_packed_reference(
    x: torch.Tensor,  # (B, T, flow_size)
    packed: FlowPack,
    config: VitsConfig,
    *,
    lengths: torch.Tensor | None = None,  # (B,) valid frames
    cond: torch.Tensor | None = None,  # (B, n_flows, nl, 2*hidden), tanh | sigmoid halves
    tier: Tier = EXACT_TIER,
) -> torch.Tensor:
    """Plain PyTorch: the kernel's arithmetic on the packed weights, step by
    step, every product at ``tier``."""
    half, hidden = config.flow_size // 2, config.hidden_size
    nl, k = config.prior_encoder_num_wavenet_layers, config.wavenet_kernel_size
    a = packed.arrays
    mask = length_mask(lengths, x.shape[1], x.dtype)
    if mask is None:
        mask = x.new_ones((*x.shape[:2], 1))
    state = x
    for s in range(config.prior_encoder_num_flows):
        read_off = half if s % 2 == 0 else 0
        read = state[..., read_off: read_off + half]
        upd = state[..., half - read_off: 2 * half - read_off]
        h = (tier_matmul(read, a["w_pre"][s], tier) + a["b_pre"][s]) * mask
        skip = 0.0
        for l in range(nl):
            g = tier_conv1d(h, a["w_gate"][s, l], a["b_gate"][s, l], tier, padding=k // 2)
            if cond is not None:
                g = g + interleave(cond[:, s, l, :hidden], cond[:, s, l, hidden:])[:, None]
            acts = torch.tanh(g[..., 0::2]) * torch.sigmoid(g[..., 1::2]) * mask
            rs = tier_matmul(acts, a["w_rs"][s, l], tier) + a["b_rs"][s, l]
            if l < nl - 1:
                h = (h + rs[..., 0::2]) * mask
            skip = skip + rs[..., 1::2]
        upd = (upd - (tier_matmul(skip, a["w_post"][s], tier) + a["b_post"][s])) * mask
        state = torch.cat((upd, read) if read_off else (read, upd), dim=-1)
    return state * mask


def flow_compute16_reference(
    x: torch.Tensor,  # (B, T, flow_size) bf16
    packed: FlowPack,
    params: ParamView,
    config: VitsConfig,
    *,
    lengths: torch.Tensor | None = None,
    speaker_embeddings: torch.Tensor | None = None,  # (B, 1, speaker_emb) bf16
    tier: Tier = EXACT_TIER,
) -> torch.Tensor:
    """Plain PyTorch: kernel 6 at bf16 serving, as the JAX kernel runs on bf16
    inputs: the speaker vectors from the bf16 ``cond_layer`` convs, x staged
    fp32 through :func:`flow_packed_reference` at ``tier``'s mode, the result
    rounded to bf16."""
    cond = (None if speaker_embeddings is None
            else pack_flow_cond(params, config, speaker_embeddings).float())
    return flow_packed_reference(x.float(), packed, config, lengths=lengths, cond=cond,
                                 tier=Tier(tier.mode)).to(torch.bfloat16)


@functools.lru_cache(maxsize=256)
def flow_plan(B: int, T: int, half: int, hidden: int, k: int, sm_count: int):
    """(tile, split) of the pre, gate, res/skip and post products, as
    ``vk_flow_capture`` takes them (tile ids of ``CONV_TILES``).

    Fitted to ``scripts/torch_flow_trio_probe.py`` on an H100 (every tile and
    split of each product at B=1, 3, 8, 16, replayed from the captured graph):
    the gate takes the 128 x 64 tile unsplit once that grid covers the SMs,
    else the 64 x 64 tile with its k * hidden / 32 steps split over 8 blocks
    (short sequences: a short chain per block); res/skip takes 64 x 64
    unsplit at 8 waves of tiles, 128 x 64 unsplit at one, else
    :func:`conv_plan`; pre and post take :func:`conv_plan`
    with uneven splits (channels off the 32-grid rounded up: the kernel
    zero-fills the tail).
    """
    def up(c):
        return -(-c // 32) * 32

    def tiles(tile, c_out):
        bm, bn = CONV_TILES[tile]
        return -(-T // bm) * -(-c_out // bn) * B

    def planned(c_in, c_out, taps):
        return list(conv_plan(B, T, up(c_in), up(c_out), taps, sm_count, uneven=True)[:2])

    gate = [0, 1] if tiles(0, 2 * hidden) >= sm_count else [1, 8]
    if (8 - 1) * -(-k * (hidden // 32) // 8) >= k * (hidden // 32):  # a split-8 block idle
        gate = planned(hidden, 2 * hidden, k)
    if tiles(1, 2 * hidden) >= 8 * sm_count:
        rs = [1, 1]
    elif tiles(0, 2 * hidden) >= sm_count:
        rs = [0, 1]
    else:
        rs = planned(hidden, 2 * hidden, 1)
    plan = [*planned(half, hidden, 1), *gate, *rs, *planned(hidden, half, 1)]
    return (ctypes.c_int * len(plan))(*plan)


def fused_flow(
    x: torch.Tensor,  # (B, T, flow_size)
    params: ParamView,
    config: VitsConfig,
    *,
    lengths: torch.Tensor | None = None,  # (B,) valid frames; None = all T
    speaker_embeddings: torch.Tensor | None = None,  # (B, 1, speaker_emb)
    packed: FlowPack | None = None,  # pack_flow_weights(params, config), kept by the caller
    tier: Tier = EXACT_TIER,
) -> torch.Tensor:
    """Prior latents -> flow latents (B, T, flow_size), zero at and past each length.

    CPU tensors take :func:`flow_reference` at the exact tier and
    :func:`flow_packed_reference` at the others (:func:`flow_compute16_reference`
    at bf16 serving); CUDA tensors launch the kernels (fp32, or bf16 with
    ``tier.bf16_compute``; contiguous, no autograd, flow_size // 2 a multiple
    of 16 and hidden_size of 32) or raise, including on what the TPU kernel
    silently gets wrong: a WaveNet dilation rate other than 1 (it reads its k
    taps contiguously) and an odd number of flows. Without ``packed`` the
    weights are packed, and the launches captured, on the call.
    """
    acts = [x] if speaker_embeddings is None else [x, speaker_embeddings]
    if tier.bf16_values and not tier.bf16_compute:
        raise ValueError("flow kernel: its values are fp32 (the JAX kernel has no value dtype)")
    io16 = tier.bf16_compute
    dtype = torch.bfloat16 if io16 else torch.float32
    if any(t.dtype != dtype for t in acts):
        raise ValueError(f"flow kernel at the {tier.name} tier takes {dtype} inputs")
    if not on_cuda("fused_flow", *acts, dtype=dtype):
        if io16:
            return flow_compute16_reference(
                x, packed or pack_flow_weights(params, config), params, config,
                lengths=lengths, speaker_embeddings=speaker_embeddings, tier=tier)
        if tier.mode == EXACT:
            return flow_reference(x, params, config, lengths=lengths,
                                  speaker_embeddings=speaker_embeddings)
        cond = (None if speaker_embeddings is None
                else pack_flow_cond(params, config, speaker_embeddings))
        return flow_packed_reference(x, packed or pack_flow_weights(params, config), config,
                                     lengths=lengths, cond=cond, tier=tier)
    B, T, C = x.shape
    half, hidden = config.flow_size // 2, config.hidden_size
    nl, k, n = (config.prior_encoder_num_wavenet_layers, config.wavenet_kernel_size,
                config.prior_encoder_num_flows)
    if C != config.flow_size:
        raise ValueError(f"flow kernel: input has {C} channels, flow_size is {config.flow_size}")
    if config.wavenet_dilation_rate != 1 and nl > 1:
        raise ValueError("flow kernel needs wavenet_dilation_rate == 1, got "
                         f"{config.wavenet_dilation_rate}")
    if half % 16 or hidden % 32:
        raise ValueError(f"flow kernel needs flow_size // 2 % 16 == 0 and hidden_size % 32 == 0 "
                         f"(got {half}, {hidden})")
    if n % 2 or k % 2 == 0:
        raise ValueError(f"flow kernel needs an even number of flows and an odd kernel size "
                         f"(got {n} flows, k={k})")
    if packed is None:
        packed = pack_flow_weights(params, config)
    on_cuda("fused_flow", packed.buffer)
    no_autograd("fused_flow", *acts, packed.buffer)
    ws = packed.workspace(config, B, T, speaker_embeddings is not None, tier.mode, io16)
    if speaker_embeddings is not None and speaker_embeddings.shape != (B, 1, ws.emb_size):
        raise ValueError(f"flow kernel: speaker embeddings {tuple(speaker_embeddings.shape)} "
                         f"!= ({B}, 1, {ws.emb_size})")
    lens = ws.full if lengths is None else cuda_lengths(lengths, B, T, x.device)
    out = torch.empty_like(x)
    ws_x, ws_emb = (ws.x16, ws.emb16) if io16 else (ws.x, ws.emb)
    with ws.lock, on_device(x):
        check(library().vk_flow_run(
            ws.exec, ws_x.data_ptr(), x.data_ptr(), ws.lens.data_ptr(), lens.data_ptr(),
            None if ws_emb is None else ws_emb.data_ptr(),
            None if speaker_embeddings is None else speaker_embeddings.data_ptr(), B, T, C,
            ws.emb_size, out.data_ptr(), x.element_size(), stream_of(x)), "flow kernels")
    count_launch(fused_flow)
    return out


fused_flow.launches = 0
