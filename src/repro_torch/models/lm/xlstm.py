"""xLSTM blocks: the mLSTM (matrix memory, parallel over time) and the
sLSTM (sequential). Counterpart of ``repro/models/lm/xlstm.py``.

The mLSTM is a linear RNN with matrix state C_t = f_t C_{t-1} + i_t k_t
v_t^T and normalizer n_t = f_t n_{t-1} + i_t k_t; y_t = (C_t q_t) /
max(|n_t . q_t|, 1). The prefill runs ``ssm.chunked_linear_rnn`` with N
= d_k and P = d_v + 1 (the extra column carries the normalizer: v_aug =
[v, 1]); the decode keeps the normalizer beside the state, as the
reference's cache does.

The sLSTM's hidden state feeds its gates, so it runs step by step:
``scan.scan`` over time (the reference's ``lax.scan``; outside the dry
run, a Python loop), with the exponential gating's stabilizer ``m``
starting at -1e30.

Serve modes: the reference's quantization policy leaves the mLSTM's
input/forget gate projection ``b/wif`` float, and its ``qlinear`` cannot
take a float matrix in a serve mode, so the reference cannot serve this
family quantized. The port keeps the policy and raises ``ValueError``
naming ``b/wif``; the family serves with ``quant_mode="none"``.

The decode steps update their cache in place (``copy_``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.lm.layers import (dense_init, lead_shape,
                                          normal_init, qlinear, rmsnorm, silu,
                                          softplus)
from repro_torch.models.lm.scan import scan
from repro_torch.models.lm.ssm import chunked_linear_rnn, linear_rnn_step

__all__ = ["mlstm_arrays", "slstm_arrays", "mlstm_forward",
           "init_mlstm_cache", "mlstm_step", "slstm_forward",
           "init_slstm_cache", "slstm_step"]


def _heads(cfg):
    di = cfg.d_model * cfg.xlstm_proj_factor
    H = cfg.n_heads
    dk = di // H // 2            # query/key dim per head
    dv = di // H                 # value dim per head
    return di, H, dk, dv


# --- mLSTM ----------------------------------------------------------------------

def mlstm_arrays(cfg, rng: np.random.Generator, depth=None):
    """The mLSTM block's parameters as float32 numpy arrays with the
    shapes and scales of the JAX ``init_mlstm``, stacked on the leading
    ``depth`` axes."""
    d = cfg.d_model
    di, H, dk, dv = _heads(cfg)
    return {"w_gate": dense_init(rng, d, di, depth),      # z gate
            "w_up": dense_init(rng, d, di, depth),        # x path
            "wq": dense_init(rng, di, H * dk, depth),
            "wk": dense_init(rng, di, H * dk, depth),
            "wv": dense_init(rng, di, H * dv, depth),
            "wif": dense_init(rng, di, 2 * H, depth),     # input+forget
            "norm_w": np.ones(lead_shape(depth) + (di,), np.float32),
            "down": dense_init(rng, di, d, depth)}


def _mlstm_qkv(params, xi, cfg, B, S):
    di, H, dk, dv = _heads(cfg)
    mode = cfg.quant_mode
    if mode.startswith("serve") and not isinstance(params["wif"], tuple):
        raise ValueError(
            f"{mode}: the mLSTM's gate projection b/wif is a float leaf "
            "(the quantization policy leaves it unquantized, as the "
            "reference's does), and a serve mode's qlinear takes only "
            "(codes, scale); serve the xlstm family with quant_mode='none'")
    q = qlinear(xi, params["wq"], mode).reshape(B, S, H, dk) * dk ** -0.5
    k = qlinear(xi, params["wk"], mode).reshape(B, S, H, dk) * dk ** -0.5
    v = qlinear(xi, params["wv"], mode).reshape(B, S, H, dv)
    gates = qlinear(xi, params["wif"], mode).reshape(B, S, H, 2).to(
        torch.float32)
    i_gate = torch.exp(-softplus(-gates[..., 0]))          # sigmoid, stable
    log_f = -softplus(-gates[..., 1])                      # log sigmoid
    return q, k, v, i_gate, log_f


def mlstm_forward(params, x_res: torch.Tensor, cfg) -> torch.Tensor:
    """(B, S, d) -> (B, S, d)."""
    B, S, _ = x_res.shape
    di, H, dk, dv = _heads(cfg)
    mode = cfg.quant_mode
    z = qlinear(x_res, params["w_gate"], mode)
    xi = qlinear(x_res, params["w_up"], mode)
    q, k, v, i_gate, log_f = _mlstm_qkv(params, xi, cfg, B, S)
    v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    # per-head keys: groups == heads in the generic scan
    y, _ = chunked_linear_rnn(log_f,
                              (k * i_gate[..., None]).to(torch.float32),
                              q.to(torch.float32), v_aug, cfg.ssm_chunk)
    num, den = y[..., :dv], y[..., dv:]
    h = num / torch.clamp(torch.abs(den), min=1.0)
    h = h.reshape(B, S, di) * silu(z)
    h = rmsnorm(h, params["norm_w"])
    return qlinear(h, params["down"], mode)


def init_mlstm_cache(cfg, batch: int, dtype: torch.dtype,
                     device: DeviceLike = None):
    """The matrix memory (B, H, dk, dv) and, beside it, the normalizer
    (B, H, dk), both float32 and zeroed (``dtype`` is unused, as in the
    reference)."""
    device = resolve_device(device)
    _, H, dk, dv = _heads(cfg)
    return {"state": torch.zeros((batch, H, dk, dv), dtype=torch.float32,
                                 device=device),
            "norm": torch.zeros((batch, H, dk), dtype=torch.float32,
                                device=device)}


def mlstm_step(params, x_res: torch.Tensor, cfg, cache):
    """Decode step. x_res: (B, 1, d) -> ((B, 1, d), cache), the cache's
    tensors updated in place."""
    B = x_res.shape[0]
    di, H, dk, dv = _heads(cfg)
    mode = cfg.quant_mode
    z = qlinear(x_res[:, 0], params["w_gate"], mode)
    xi = qlinear(x_res[:, 0], params["w_up"], mode)
    q, k, v, i_gate, log_f = _mlstm_qkv(params, xi[:, None], cfg, B, 1)
    ki = (k * i_gate[..., None])[:, 0].to(torch.float32).reshape(B, H, dk)
    qf = q[:, 0].to(torch.float32).reshape(B, H, dk)
    num, state = linear_rnn_step(cache["state"], log_f[:, 0], ki, qf,
                                 v[:, 0])
    f = torch.exp(log_f[:, 0])[..., None]                   # (B, H, 1)
    norm = f * cache["norm"] + ki                           # (B, H, dk)
    den = torch.sum(norm * qf, dim=-1, keepdim=True)        # (B, H, 1)
    h = (num.to(torch.float32)
         / torch.clamp(torch.abs(den), min=1.0)).to(x_res.dtype)
    h = h.reshape(B, di) * silu(z)
    h = rmsnorm(h, params["norm_w"])
    out = qlinear(h, params["down"], mode)
    cache["state"].copy_(state)
    cache["norm"].copy_(norm)
    return out[:, None], cache


# --- sLSTM ----------------------------------------------------------------------

def slstm_arrays(cfg, rng: np.random.Generator, depth=None):
    """The sLSTM block's parameters as float32 numpy arrays with the
    shapes and scales of the JAX ``init_slstm`` (the four gates i, f, z, o
    from the input, and a block-diagonal recurrence ``r`` (H, dh, 4 dh) /
    sqrt(dh)), stacked on the leading ``depth`` axes."""
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    lead = lead_shape(depth)
    return {"w_in": dense_init(rng, d, 4 * d, depth),
            "r": normal_init(rng, (H, dh, 4 * dh), dh, depth),
            "b": np.zeros(lead + (4 * d,), np.float32),
            "norm_w": np.ones(lead + (d,), np.float32),
            "down": dense_init(rng, d, d, depth)}


def _slstm_cell(params, cfg, x_t, state):
    """x_t: (B, 4d), the input's projected contribution; state: (h, c, n,
    m). Returns the new state."""
    h, c, n, m = state
    B = h.shape[0]
    H = cfg.n_heads
    dh = cfg.d_model // H
    rec = torch.einsum("bhd,hde->bhe", h.reshape(B, H, dh),
                       params["r"].to(h.dtype)).reshape(B, 4 * cfg.d_model)
    gates = (x_t + rec + params["b"].to(x_t.dtype)).to(torch.float32)
    gi, gf, gz, go = torch.chunk(gates, 4, dim=-1)
    log_f = -softplus(-gf)                             # log sigmoid(f)
    m_new = torch.maximum(log_f + m, gi)               # stabilizer
    i = torch.exp(gi - m_new)
    f = torch.exp(log_f + m - m_new)
    c_new = f * c + i * torch.tanh(gz)
    n_new = f * n + i
    h_new = torch.sigmoid(go) * c_new / torch.clamp(n_new, min=1.0)
    return h_new.to(x_t.dtype), c_new, n_new, m_new


def _slstm_state0(cfg, batch: int, dtype: torch.dtype, device):
    d = cfg.d_model
    f32 = torch.float32
    return (torch.zeros((batch, d), dtype=dtype, device=device),
            torch.zeros((batch, d), dtype=f32, device=device),
            torch.zeros((batch, d), dtype=f32, device=device),
            torch.full((batch, d), -1e30, dtype=f32, device=device))


def _slstm_body(cfg):
    def step(state, x_t, r, b):
        state = _slstm_cell({"r": r, "b": b}, cfg, x_t, state)
        return state, state[0]
    return step


def slstm_forward(params, x_res: torch.Tensor, cfg) -> torch.Tensor:
    """(B, S, d) -> (B, S, d), one cell step per position."""
    B, S, _ = x_res.shape
    mode = cfg.quant_mode
    x_in = qlinear(x_res, params["w_in"], mode)        # (B, S, 4d)
    _, hs = scan(_slstm_body(cfg),
                 _slstm_state0(cfg, B, x_res.dtype, x_res.device), x_in,
                 axis=1, consts=(params["r"], params["b"]))
    h = rmsnorm(hs, params["norm_w"])
    return qlinear(h, params["down"], mode)


def init_slstm_cache(cfg, batch: int, dtype: torch.dtype,
                     device: DeviceLike = None):
    """h (B, d) in ``dtype``; c, n (zeros) and m (-1e30) in float32."""
    h, c, n, m = _slstm_state0(cfg, batch, dtype, resolve_device(device))
    return {"h": h, "c": c, "n": n, "m": m}


def slstm_step(params, x_res: torch.Tensor, cfg, cache):
    """Decode step. x_res: (B, 1, d) -> ((B, 1, d), cache), the cache's
    tensors updated in place."""
    mode = cfg.quant_mode
    x_in = qlinear(x_res[:, 0], params["w_in"], mode)
    state = (cache["h"], cache["c"], cache["n"], cache["m"])
    new = _slstm_cell(params, cfg, x_in, state)
    out = qlinear(rmsnorm(new[0], params["norm_w"]), params["down"], mode)
    for name, t in zip(("h", "c", "n", "m"), new):
        cache[name].copy_(t)
    return out[:, None], cache
