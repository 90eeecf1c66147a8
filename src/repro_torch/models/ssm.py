"""State-space and recurrent mixers of the port (``src/repro/models/
ssm.py``): Mamba-1's selective SSM (Jamba's mixer) and the xLSTM cells
(the mLSTM's matrix memory, the sLSTM's scalar memory).

The reference's scans are plain JAX, not Pallas, so their plain PyTorch
port is their twin; no kernel is written for them.  Mamba's prefill
walks chunks of ``cfg.ssm.chunk`` steps in a Python loop, and composes
the affine recurrence inside one chunk by log-step doubling over the
chunk axis (``_affine_scan``), where the reference runs an
``associative_scan``: the two associate the products differently, so
they agree to f32 round-off, not bit for bit.  The xLSTM cells run as
exact sequential loops over time in float32, step for step the
reference's, and the same loop is the decode step.  Their projections
run in blocks of ``ROWS`` time steps (``_in_row_blocks``), so that a
prefill continuing a reused state gives the cold prefill's bits.  Under
``cfg.remat`` a differentiated loop runs in chunks of ``REMAT_STEPS``
steps recomputed in the backward (``_scan``): autograd keeps the carries
at chunk edges, not every step's state, and the gradients are bit for
bit the unchunked loop's.

Parameter keys, shapes and dtypes are the reference's; the random
numbers come from the caller's ``torch.Generator``.  A mixer returns its
new state and never writes into the one it was given.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .config import ModelConfig
from .layers import Params, _dtype, _init, rmsnorm


# ---------------------------------------------------------------------------
# Mamba


def _dt_rank(cfg: ModelConfig) -> int:
    return cfg.ssm.dt_rank or math.ceil(cfg.d_model / 16)


def init_mamba(cfg: ModelConfig, gen) -> Params:
    s = cfg.ssm
    dt = _dtype(cfg)
    d = cfg.d_model
    d_in = s.expand * d
    r = _dt_rank(cfg)
    dev = gen.device
    a = torch.arange(1, s.d_state + 1, dtype=torch.float32,
                     device=dev).repeat(d_in, 1)
    return {
        "in_proj": _init(gen, (d, 2 * d_in), dt),
        "conv_w": _init(gen, (s.d_conv, d_in), dt, scale=0.5),
        "conv_b": torch.zeros((d_in,), dtype=dt, device=dev),
        "x_proj": _init(gen, (d_in, r + 2 * s.d_state), dt),
        "dt_proj": _init(gen, (r, d_in), dt),
        "dt_bias": torch.full((d_in,), -4.6, dtype=dt, device=dev),
        "A_log": torch.log(a),
        "D": torch.ones((d_in,), dtype=torch.float32, device=dev),
        "out_proj": _init(gen, (d_in, d), dt),
    }


def _causal_conv(x, w, b, state=None):
    """x: (B, S, C); w: (K, C) depthwise; state: (B, K-1, C), the past
    inputs.  Returns (out, new state)."""
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros(x.shape[:1] + (k - 1,) + x.shape[2:])
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], 1)                      # (B, S+K-1, C)
    s = x.shape[1]
    out = sum(xp[:, i:i + s] * w[i] for i in range(k))
    new_state = xp[:, -(k - 1):] if k > 1 else None
    return out + b, new_state


def _affine_scan(a, b):
    """Inclusive scan over axis 1 of the affine maps h -> a_t h + b_t,
    composed as (a1, b1) then (a2, b2) = (a1 a2, a2 b1 + b2), by
    Hillis-Steele doubling: ceil(log2 Q) steps of a few elementwise ops
    over the whole chunk.  Returns (A, B) with h_t = A_t h_0 + B_t.
    Products of exp(dt A) underflow over a chunk, so the running product
    is kept as such (no exp of a cumulative sum divided back out)."""
    q, d = a.shape[1], 1
    while d < q:
        a_hi = a[:, d:]
        b = torch.cat([b[:, :d], a_hi * b[:, :-d] + b[:, d:]], 1)
        a = torch.cat([a[:, :d], a_hi * a[:, :-d]], 1)
        d *= 2
    return a, b


def mamba_forward(cfg: ModelConfig, p: Params, x,
                  state: Optional[Tuple] = None):
    """x: (B, S, d).  state: (conv_state (B, K-1, d_in), h (B, d_in, N)
    float32).  Returns (y, (new conv state, new h)).

    One step (S == 1) reads both parts of the state.  A prefill (S > 1)
    reads only the conv state: its scan starts from h = 0, as the
    reference's does (``repro/models/ssm.py:124``), so a prefill that
    continues a reused prefix restarts the SSM state (a fault the port
    keeps for parity)."""
    s_cfg = cfg.ssm
    b, s, d = x.shape
    d_in = s_cfg.expand * d
    n = s_cfg.d_state
    r = _dt_rank(cfg)
    chunk = s_cfg.chunk or s

    xz = x @ p["in_proj"]
    xi, z = xz[..., :d_in], xz[..., d_in:]
    conv_state = state[0] if state is not None else None
    xc, new_conv_state = _causal_conv(xi, p["conv_w"], p["conv_b"],
                                      conv_state)
    xc = F.silu(xc)

    dbc = xc @ p["x_proj"]
    bmat = dbc[..., r:r + n].float()                      # (B, S, N)
    cmat = dbc[..., r + n:].float()                       # (B, S, N)
    dt = F.softplus((dbc[..., :r] @ p["dt_proj"]).float()
                    + p["dt_bias"].float())               # (B, S, d_in)
    a = -torch.exp(p["A_log"])                            # (d_in, N)
    xcf = xc.float()

    if s == 1:   # decode step
        h0 = state[1] if state is not None else xcf.new_zeros((b, d_in, n))
        da = torch.exp(dt[:, 0, :, None] * a)             # (B, d_in, N)
        dbx = dt[:, 0, :, None] * bmat[:, 0, None, :] * xcf[:, 0, :, None]
        h = da * h0 + dbx
        y = torch.matmul(h, cmat[:, 0, :, None])[..., 0][:, None]
    else:
        if s % chunk and s >= chunk:
            raise ValueError(f"mamba_forward: {s} tokens are not a "
                             f"multiple of the scan's chunk of {chunk}")
        q = min(chunk, s)
        # the reference's h0 = zeros on every prefill (ssm.py:124)
        h = xcf.new_zeros((b, d_in, n))
        ys = []
        for i in range(0, s, q):
            dtq, xq = dt[:, i:i + q], xcf[:, i:i + q]
            da = torch.exp(dtq[..., None] * a)            # (B, Q, d_in, N)
            dbx = dtq[..., None] * bmat[:, i:i + q, None, :] * xq[..., None]
            acum, hrel = _affine_scan(da, dbx)
            hs = acum * h[:, None] + hrel
            ys.append(torch.matmul(hs, cmat[:, i:i + q, :, None])[..., 0])
            h = hs[:, -1]
        y = torch.cat(ys, 1)
    y = y + p["D"] * xcf
    out = (y * F.silu(z.float())).to(x.dtype)
    return out @ p["out_proj"], (new_conv_state, h)


# ---------------------------------------------------------------------------
# xLSTM: the loops over time

ROWS = 16
# time steps a chunk under remat: autograd saves ~3 (B, H, Dh, Dh)
# float32 states a step of an mLSTM layer (C, k v^T, the new C), 12 MB a
# token at xlstm-350m's width, so a chunk of 64 holds ~0.8 GB at batch 1
# while its backward runs
REMAT_STEPS = 64


def _loop(step, carry, xs):
    """``carry, h_t = step(carry, *x_t)`` for t in order, x_t the t-th
    time slice of each (B, S, ...) tensor of ``xs``.  Returns (carry, the
    h_t stacked along time).  The slices come from one ``unbind`` per
    input, whose backward stacks the steps' gradients once (a slice per
    step would add a full-size zero-padded gradient per step)."""
    hs = []
    for x_t in zip(*(x.unbind(1) for x in xs)):
        carry, h = step(carry, *x_t)
        hs.append(h)
    return carry, torch.stack(hs, 1)


class _Chunk(torch.autograd.Function):
    """A chunk of a loop over time that records nothing: its forward runs
    under ``no_grad`` and keeps only its inputs (the carry at its start
    and its slices of the loop's inputs); its backward runs the chunk
    again with autograd and backpropagates through it.  For a step that
    reads nothing but its carry and its inputs, the backward's ops and
    their order are the unchunked loop's, so are its gradients."""

    @staticmethod
    def forward(ctx, step, n_carry, *args):
        ctx.step, ctx.n_carry = step, n_carry
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*args)
        with torch.no_grad():
            carry, hs = _loop(step, args[:n_carry], args[n_carry:])
        return (*carry, hs)

    @staticmethod
    def backward(ctx, *grads):
        args = [a.detach().requires_grad_(a.requires_grad)
                for a in ctx.saved_tensors]
        with torch.enable_grad():
            carry, hs = _loop(ctx.step, tuple(args[:ctx.n_carry]),
                              args[ctx.n_carry:])
        outs = [(o, g) for o, g in zip((*carry, hs), grads) if g is not None]
        wrt = [a for a in args if a.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in outs], wrt,
                                       [g for _, g in outs],
                                       allow_unused=True))
        return (None, None) + tuple(next(got) if a.requires_grad else None
                                    for a in args)


def _scan(step, carry, xs, remat: bool, closed: bool = False):
    """``_loop``, and with ``remat`` in chunks of REMAT_STEPS steps, the
    last one shorter when S is not a multiple, whose backward recomputes
    the chunk from the carry at its start; the chunks come from one
    ``split`` per input, for the reason of ``_loop``'s ``unbind``.  A
    step that reads only its carry and its inputs runs its chunks as
    ``_Chunk`` (no graph in the forward).  A step that also reads tensors
    it closes over (``closed``: the sLSTM's recurrent weights) runs them
    under ``torch.utils.checkpoint`` (non-reentrant): the graph stays the
    unchunked loop's, so the weights' gradients, summed over every step,
    add up in the same order.  Either way the gradients are the
    unchunked loop's, bit for bit."""
    if not remat:
        return _loop(step, carry, xs)
    parts = []
    for chunk in zip(*(x.split(REMAT_STEPS, 1) for x in xs)):
        if closed:
            carry, h = checkpoint(_loop, step, carry, chunk,
                                  use_reentrant=False)
        else:
            *carry, h = _Chunk.apply(step, len(carry), *carry, *chunk)
            carry = tuple(carry)
        parts.append(h)
    return carry, torch.cat(parts, 1)


def _remat(cfg: ModelConfig, x) -> bool:
    """Chunked remat of a loop over time: under ``cfg.remat``, for a
    forward that autograd records (a prefill or a decode step records
    none)."""
    return cfg.remat and torch.is_grad_enabled() and x.requires_grad


# ---------------------------------------------------------------------------
# xLSTM: the reference's bf16 rounding points


class _SiluBF16(torch.autograd.Function):
    """``jax.nn.silu`` of a bf16 tensor as the reference computes it on
    its CPU backend: ``x * sigmoid(x)``, the sigmoid expanded as ``1 /
    (1 + exp(-x))`` with a bf16 rounding after each operation, and its
    gradient by JAX's rules (the logistic's ``s (1 - s)``, the product's
    two terms), each operation rounded to bf16.  ``F.silu`` rounds once,
    and through the xLSTM cells' exponential gates that last-bit
    difference shows in the gradients (``tests/test_torch_ssm_bf16.py``)."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + (g * x) * (s * (1 - s))


def _silu(x):
    """The reference's silu: ``_SiluBF16`` in bf16, ``F.silu`` in any
    other dtype (float32 agrees to round-off either way)."""
    return _SiluBF16.apply(x) if x.dtype == torch.bfloat16 else F.silu(x)


def _ffn(p: Params, x):
    """The sLSTM block's SwiGLU FFN (``layers.mlp_forward``) with the
    reference's silu (``_silu``)."""
    return (_silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory)


def _in_row_blocks(fn, *xs):
    """``fn(*xs)`` (a tuple of (B, S, ...) tensors) for a function that
    treats every (batch, time) row on its own, evaluated over blocks of
    ROWS time steps and concatenated along time.  A GEMM's library picks
    its kernel, and with it the rounding of each row, by the row count;
    in blocks a row's bits do not depend on the call's length.  That
    matters for the xLSTM cells, whose exponential gates and normaliser
    amplify a last-bit difference in bf16 into the logits (by ~0.5 on the
    card at xlstm-350m's full config): with blocks, a prefill that
    continues a reused state at a multiple of ROWS tokens gives the cold
    prefill's bits."""
    s = xs[0].shape[1]
    if s <= ROWS:
        return fn(*xs)
    # one split per input: its backward concatenates the blocks'
    # gradients once, where a slice per block would add a full-size
    # zero-padded gradient per block
    parts = [fn(*block) for block in zip(*(x.split(ROWS, 1) for x in xs))]
    return tuple(torch.cat(col, 1) for col in zip(*parts))


def init_mlstm(cfg: ModelConfig, gen) -> Params:
    dt = _dtype(cfg)
    d = cfg.d_model
    d_in = int(cfg.xlstm.proj_factor * d)
    h = cfg.n_heads
    dev = gen.device
    return {
        "up": _init(gen, (d, 2 * d_in), dt),
        "wq": _init(gen, (d_in, d_in), dt),
        "wk": _init(gen, (d_in, d_in), dt),
        "wv": _init(gen, (d_in, d_in), dt),
        "wi": _init(gen, (d_in, h), torch.float32, scale=0.01),
        "wf": _init(gen, (d_in, h), torch.float32, scale=0.01),
        "bf": torch.full((h,), 3.0, dtype=torch.float32, device=dev),
        "bi": torch.zeros((h,), dtype=torch.float32, device=dev),
        "gn": torch.ones((d_in,), dtype=dt, device=dev),
        "down": _init(gen, (d_in, d), dt),
    }


def _mlstm_step(carry, q, k, v, i_raw, log_f):
    """One mLSTM step.  carry: (C (B, H, Dh, Dh), n (B, H, Dh), m (B,
    H)); q/k/v: (B, H, Dh); the input gate and the forget gate's
    logsigmoid: (B, H).  Returns (carry, h (B, H, Dh))."""
    c, nrm, m = carry
    lfm = log_f + m
    m_new = torch.maximum(lfm, i_raw)
    fg = torch.exp(lfm - m_new)[..., None]
    ig = torch.exp(i_raw - m_new)[..., None]
    c = fg[..., None] * c + ig[..., None] * (k[..., :, None] * v[..., None, :])
    nrm = fg * nrm + ig * k
    h_num = torch.matmul(q[..., None, :], c)[..., 0, :]
    h_den = torch.maximum((q * nrm).sum(-1).abs(), torch.exp(-m_new))
    return (c, nrm, m_new), h_num / h_den[..., None]


def mlstm_forward(cfg: ModelConfig, p: Params, x,
                  state: Optional[Tuple] = None):
    """x: (B, S, d).  An exact sequential loop over time, also the
    decode step.  state: (C, n, m) float32.  Returns (y, new state)."""
    b, s, d = x.shape
    d_in = int(cfg.xlstm.proj_factor * d)
    h = cfg.n_heads
    dh = d_in // h

    def project(x):
        up = x @ p["up"]
        xm, z = up[..., :d_in], up[..., d_in:]
        xmf = xm.float()
        return (xm @ p["wq"], xm @ p["wk"], xm @ p["wv"],
                xmf @ p["wi"] + p["bi"], xmf @ p["wf"] + p["bf"], z)
    q, k, v, i_raw, f_raw, z = _in_row_blocks(project, x)
    q = q.view(b, s, h, dh)
    # the reference divides by the constant rounded to the activations'
    # dtype (a JAX weak type), not by the float64 one
    k = k.view(b, s, h, dh) / torch.tensor(dh ** 0.5, dtype=k.dtype)
    v = v.view(b, s, h, dh)

    if state is None:
        f32 = dict(dtype=torch.float32, device=x.device)
        carry = (torch.zeros((b, h, dh, dh), **f32),
                 torch.zeros((b, h, dh), **f32), torch.zeros((b, h), **f32))
    else:
        carry = tuple(state)
    # the forget gate's logsigmoid for every step at once: an elementwise
    # op, the same numbers as one a step, one launch instead of S
    carry, hseq = _scan(_mlstm_step, carry,
                        (q.float(), k.float(), v.float(), i_raw,
                         F.logsigmoid(f_raw)), _remat(cfg, x))
    hseq = hseq.reshape(b, s, d_in).to(x.dtype)

    def down(hseq, z):
        return (rmsnorm(hseq, p["gn"], cfg.norm_eps) * _silu(z)
                @ p["down"],)
    return _in_row_blocks(down, hseq, z)[0], carry


# ---------------------------------------------------------------------------
# xLSTM: sLSTM (scalar memory, post-up-projection block with FFN)

_GATES = ("i", "f", "z", "o")


def init_slstm(cfg: ModelConfig, gen) -> Params:
    dt = _dtype(cfg)
    d = cfg.d_model
    dh = d // cfg.n_heads
    dev = gen.device
    p = {}
    for g in _GATES:
        p[f"w{g}"] = _init(gen, (d, d), dt)
        p[f"r{g}"] = _init(gen, (cfg.n_heads, dh, dh), dt,
                           scale=1.0 / dh ** 0.5)
        p[f"b{g}"] = torch.full((d,), 1.0 if g == "f" else 0.0,
                                dtype=torch.float32, device=dev)
    p["gn"] = torch.ones((d,), dtype=dt, device=dev)
    d_ff = cfg.d_ff or 4 * d // 3
    p["ffn"] = {"wg": _init(gen, (d, d_ff), dt),
                "wu": _init(gen, (d, d_ff), dt),
                "wd": _init(gen, (d_ff, d), dt)}
    return p


def slstm_forward(cfg: ModelConfig, p: Params, x,
                  state: Optional[Tuple] = None):
    """x: (B, S, d).  An exact sequential loop over time.  state: (c, n,
    m, h), each (B, d) float32.  Returns (y, new state); y includes the
    block's FFN."""
    b, s, d = x.shape
    h = cfg.n_heads
    dh = d // h

    wx = _in_row_blocks(lambda x: tuple((x @ p[f"w{g}"]).float()
                                        for g in _GATES), x)
    if state is None:
        z = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        state = (z, z, z - 10.0, z)
    # the four recurrent matrices as one (H, Dh, 4 Dh) product a step.
    # The reference casts them to float32 inside its scan body, so where
    # they record gradients each step's float32 gradient is rounded to
    # their dtype and the steps' gradients add up in it, latest step
    # first, as its scan's transpose adds them: here too, by one cast a
    # step.  Without gradients one cast serves every step (the same bits).
    r = torch.cat([p[f"r{g}"] for g in _GATES], -1)
    per_step = torch.is_grad_enabled() and r.requires_grad
    if not per_step:
        r = r.float()
    bias = [p[f"b{g}"] for g in _GATES]

    def step(carry, *wx_t):
        c, nrm, m, hprev = carry
        rec = torch.bmm(hprev.view(b, h, dh).transpose(0, 1),
                        r.float() if per_step else r)
        rec = rec.view(h, b, 4, dh).permute(2, 1, 0, 3).reshape(4, b, d)
        i_raw, f_raw, z_raw, o_raw = (wx_t[j] + rec[j] + bias[j]
                                      for j in range(4))
        z_t = torch.tanh(z_raw)
        o_t = torch.sigmoid(o_raw)
        log_f = F.logsigmoid(f_raw)
        m_new = torch.maximum(log_f + m, i_raw)
        ig = torch.exp(i_raw - m_new)
        fg = torch.exp(log_f + m - m_new)
        c = fg * c + ig * z_t
        nrm = fg * nrm + ig
        hprev = o_t * c / nrm.clamp_min(1e-6)
        return (c, nrm, m_new, hprev), hprev
    state, hseq = _scan(step, tuple(state), wx, _remat(cfg, x),
                        closed=True)
    hseq = hseq.to(x.dtype)

    def ffn(hseq):
        hseq = rmsnorm(hseq, p["gn"], cfg.norm_eps)
        return (hseq + _ffn(p["ffn"], hseq),)
    return _in_row_blocks(ffn, hseq)[0], state
