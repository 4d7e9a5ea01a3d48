"""Chunked linear-RNN scan (Mamba2 / SSD) and the Mamba2 block.
Counterpart of ``repro/models/lm/ssm.py``.

The SSD recurrence ``S_t = a_t S_{t-1} + B_t x_t^T``, ``y_t = C_t . S_t``
(per head; ``a_t`` a scalar decay, ``S`` in R^{N x P}) runs as the
reference's chunked algorithm: within a chunk, attention-like einsums;
across chunks, the (H, N, P) state carried in float32 by a Python loop
(the reference's ``lax.scan``). The same scan serves the mLSTM
(``xlstm.py``): N = d_k, P = d_v + 1, decay = log sigmoid(forget gate).

The decode steps update their cache in place (``copy_`` into the
tensors the caller passed, which are also returned): the serve loops
keep the cache they pass and never take the returned one.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.lm.layers import (dense_init, lead_shape, qlinear,
                                          rmsnorm, silu, softplus)

__all__ = ["chunked_linear_rnn", "linear_rnn_step", "mamba2_arrays",
           "mamba2_forward", "init_mamba2_cache", "mamba2_step"]


def chunked_linear_rnn(log_a: torch.Tensor, B_in: torch.Tensor,
                       C_out: torch.Tensor, x: torch.Tensor, chunk: int,
                       init_state: Optional[torch.Tensor] = None):
    """y_t = C_t . (sum_{s<=t} prod_{r in (s,t]} a_r B_s x_s^T), by chunks.

    log_a: (Bt, S, H) per-step log decay (<= 0); B_in: (Bt, S, G, N) write
    keys; C_out: (Bt, S, G, N) read keys; x: (Bt, S, H, P) values. Head
    ``h`` uses key group ``h // (H // G)``. Chunks of ``min(chunk, S)``
    steps; ``S`` must be a multiple (``ValueError``). ``init_state``:
    (Bt, G, H // G, N, P) float32, zeros when omitted. Returns y (Bt, S,
    H, P) in x's dtype and the final state (Bt, H, N, P) float32.
    """
    Bt, S, H, P = x.shape
    G, N = B_in.shape[2], B_in.shape[3]
    Hg = H // G
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"S={S} % chunk {L} != 0")
    nc = S // L

    la = log_a.reshape(Bt, nc, L, G, Hg)
    xs = x.reshape(Bt, nc, L, G, Hg, P)
    Bi = B_in.reshape(Bt, nc, L, G, N)
    Co = C_out.reshape(Bt, nc, L, G, N)
    lcum = torch.cumsum(la, dim=2)                      # inclusive cumsum
    state = init_state
    if state is None:
        state = torch.zeros((Bt, G, Hg, N, P), dtype=torch.float32,
                            device=x.device)
    idx = torch.arange(L, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None, None]

    ys = []
    for c in range(nc):
        lc_c, x_c, b_c, c_c = lcum[:, c], xs[:, c], Bi[:, c], Co[:, c]
        # intra-chunk: scores[t, s] = exp(l_t - l_s) (C_t . B_s), s <= t
        cb = torch.einsum("blgn,bmgn->bglm", c_c, b_c)  # (Bt, G, L, L)
        dec = lc_c[:, :, None] - lc_c[:, None, :]       # (Bt, L, L, G, Hg)
        dec = torch.where(causal, dec, -1e30)
        w = torch.exp(dec) * cb.permute(0, 2, 3, 1)[..., None]
        y_intra = torch.einsum("blmgh,bmghp->blghp", w.to(x_c.dtype), x_c)

        # inter-chunk: y_inter[t] = exp(l_t) C_t . S_prev
        read = torch.exp(lc_c)[..., None] * c_c[:, :, :, None, :]
        y_inter = torch.einsum("blghn,bghnp->blghp", read.to(x_c.dtype),
                               state.to(x_c.dtype))

        # state: S_new = exp(l_L) S_prev + sum_s exp(l_L - l_s) B_s x_s^T
        tail = lc_c[:, -1:] - lc_c                      # l_L - l_s
        wsrc = torch.exp(tail)[..., None] * x_c         # (Bt, L, G, Hg, P)
        contrib = torch.einsum("blgn,blghp->bghnp", b_c,
                               wsrc.to(torch.float32))
        decay_L = torch.exp(lc_c[:, -1])[..., None, None]  # (Bt,G,Hg,1,1)
        state = decay_L * state + contrib
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(Bt, S, H, P)
    return y, state.reshape(Bt, H, N, P)


def linear_rnn_step(state: torch.Tensor, log_a: torch.Tensor,
                    B_in: torch.Tensor, C_out: torch.Tensor,
                    x: torch.Tensor):
    """One step. state: (Bt, H, N, P) float32; log_a: (Bt, H); B_in and
    C_out: (Bt, G, N); x: (Bt, H, P). Returns (y (Bt, H, P) in x's
    dtype, the new state); ``state`` is not written."""
    Bt, H, N, P = state.shape
    G = B_in.shape[1]
    Hg = H // G
    s = state.reshape(Bt, G, Hg, N, P)
    a = torch.exp(log_a).reshape(Bt, G, Hg)[..., None, None]
    contrib = torch.einsum("bgn,bghp->bghnp", B_in,
                           x.reshape(Bt, G, Hg, P).to(torch.float32))
    s = a * s + contrib
    y = torch.einsum("bgn,bghnp->bghp", C_out, s).to(x.dtype)
    return y.reshape(Bt, H, P), s.reshape(Bt, H, N, P)


# --- the Mamba2 block ----------------------------------------------------------

_CONV_W = 4  # causal depthwise conv width


def mamba2_arrays(cfg, rng: np.random.Generator, depth=None):
    """The Mamba2 block's parameters as float32 numpy arrays with the
    shapes and scales of the JAX ``init_mamba2`` (one projection per
    segment z, x, B, C, dt; conv taps N(0, 0.01); ``A_log`` 0, so A = -1;
    ``D`` 1; ``dt_bias`` 0), stacked on the leading ``depth`` axes."""
    d, di = cfg.d_model, cfg.d_inner
    H, N, G = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_groups
    lead = lead_shape(depth)
    conv = rng.standard_normal(lead + (_CONV_W, di), dtype=np.float32)
    return {
        "w_z": dense_init(rng, d, di, depth),
        "w_x": dense_init(rng, d, di, depth),
        "w_B": dense_init(rng, d, G * N, depth),
        "w_C": dense_init(rng, d, G * N, depth),
        "w_dt": dense_init(rng, d, H, depth),
        "conv_w": conv * np.float32(0.1),
        "conv_b": np.zeros(lead + (di,), np.float32),
        "A_log": np.zeros(lead + (H,), np.float32),
        "D": np.ones(lead + (H,), np.float32),
        "dt_bias": np.zeros(lead + (H,), np.float32),
        "norm_w": np.ones(lead + (di,), np.float32),
        "out_proj": dense_init(rng, di, d, depth),
    }


def _project(params, x, mode):
    z = qlinear(x, params["w_z"], mode)
    xv = qlinear(x, params["w_x"], mode)
    B_in = qlinear(x, params["w_B"], mode)
    C_out = qlinear(x, params["w_C"], mode)
    dt = qlinear(x, params["w_dt"], mode)
    return z, xv, B_in, C_out, dt


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (W, C) depthwise causal taps, summed from tap 0."""
    W, S = w.shape[0], x.shape[1]
    w = w.to(x.dtype)
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(W))
    return silu(out + b.to(x.dtype))


def _decay(params, dt: torch.Tensor):
    """(softplus(dt + dt_bias), its log decay dt * A), float32."""
    dt = softplus(dt.to(torch.float32) + params["dt_bias"])
    return dt, dt * -torch.exp(params["A_log"])


def mamba2_forward(params, x_res: torch.Tensor, cfg) -> torch.Tensor:
    """Training and prefill. x_res: (B, S, d) -> (B, S, d)."""
    B, S, _ = x_res.shape
    H, N, G, P = (cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_groups,
                  cfg.ssm_head_dim)
    mode = cfg.quant_mode
    z, xv, B_in, C_out, dt = _project(params, x_res, mode)
    xv = _causal_conv(xv, params["conv_w"], params["conv_b"])
    dt, log_a = _decay(params, dt)                      # (B, S, H)
    xh = xv.reshape(B, S, H, P)
    y, _ = chunked_linear_rnn(log_a,
                              B_in.reshape(B, S, G, N).to(torch.float32),
                              C_out.reshape(B, S, G, N).to(torch.float32),
                              xh * dt[..., None].to(xh.dtype), cfg.ssm_chunk)
    y = y + xh * params["D"][None, None, :, None].to(xh.dtype)
    y = y.reshape(B, S, cfg.d_inner) * silu(z)
    y = rmsnorm(y, params["norm_w"])
    return qlinear(y, params["out_proj"], mode)


def init_mamba2_cache(cfg, batch: int, dtype: torch.dtype,
                      device: DeviceLike = None):
    """The last ``_CONV_W - 1`` conv inputs in ``dtype`` and the SSM state
    (B, H, N, P) in float32, zeroed."""
    device = resolve_device(device)
    H, N, P = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    return {"conv": torch.zeros((batch, _CONV_W - 1, cfg.d_inner),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, H, N, P), dtype=torch.float32,
                               device=device)}


def mamba2_step(params, x_res: torch.Tensor, cfg, cache):
    """Decode step. x_res: (B, 1, d) -> ((B, 1, d), cache), the cache's
    tensors updated in place."""
    B = x_res.shape[0]
    H, N, G, P = (cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_groups,
                  cfg.ssm_head_dim)
    mode = cfg.quant_mode
    z, xv, B_in, C_out, dt = _project(params, x_res[:, 0], mode)

    # causal conv over (the cached last W-1 inputs, the current one)
    conv_in = torch.cat([cache["conv"],
                         xv[:, None, :].to(cache["conv"].dtype)], dim=1)
    w = params["conv_w"].to(conv_in.dtype)
    xv = silu(torch.einsum("bwc,wc->bc", conv_in, w)
              + params["conv_b"].to(conv_in.dtype))

    dt, log_a = _decay(params, dt)                      # (B, H)
    xh = xv.reshape(B, H, P)
    y, ssm = linear_rnn_step(cache["ssm"], log_a,
                             B_in.reshape(B, G, N).to(torch.float32),
                             C_out.reshape(B, G, N).to(torch.float32),
                             xh * dt[..., None].to(xh.dtype))
    y = y + xh * params["D"][None, :, None].to(xh.dtype)
    y = y.reshape(B, cfg.d_inner) * silu(z)
    y = rmsnorm(y, params["norm_w"])
    out = qlinear(y, params["out_proj"], mode)
    cache["conv"].copy_(conv_in[:, 1:])
    cache["ssm"].copy_(ssm)
    return out[:, None, :], cache
