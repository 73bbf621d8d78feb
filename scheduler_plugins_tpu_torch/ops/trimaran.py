"""Trimaran load-aware score curves over the nodes (port of
`scheduler_plugins_tpu.ops.trimaran`).

Each function mirrors one reference plugin's math (float formulas, Go
`math.Round` half-away rounding, int64 truncation), written in the JAX
package's order and association so that both packages round alike:

- `tlp_score`   TargetLoadPacking's piecewise-linear packing curve
  (trimaran targetloadpacking.go:107-193);
- `lvrb_score`  LoadVariationRiskBalancing, risk = (mu + margin *
  sigma^(1/sensitivity)) / 2 (analysis.go:34-69,
  loadvariationriskbalancing.go:94-121);
- `lroc_score`  LowRiskOverCommitment, w * riskLimit + (1 - w) * riskLoad
  with the beta-distribution overuse probability
  (lowriskovercommitment.go:157-256, beta.go:106-191);
- `peaks_score` Peaks' power jump K1 * (e^(K2 p) - e^(K2 x)) * 1e15
  (peaks.go:103-196).

Utilisation inputs are percentages of capacity, as the load-watcher
reports them (resourcestats.go:33-107). Per-pod values come in as (1,)
tensors (one-element slices of the pod table), so a solve step reads
nothing on the host.

PyTorch has no regularized incomplete beta function; `betainc` here is
the continued fraction `jax.scipy.special.betainc` evaluates (JAX
`_src/lax/special.py` `regularized_incomplete_beta_impl`), in float64.
Its `exp`, `log`, `log1p` and `lgamma` come from another math library
than XLA's, so its last bits may differ from JAX's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from scheduler_plugins_tpu_torch.utils.intmath import (
    round_half_away,
    saturating_int64,
)

MAX_SCORE = 100.0

F64 = torch.float64
F32 = torch.float32


def _clip(x, lo, hi):
    """`jnp.clip`: maximum with `lo`, then minimum with `hi` (either a
    number or a tensor), NaN propagating."""
    x = torch.clamp(x, min=lo) if not isinstance(lo, torch.Tensor) \
        else torch.maximum(x, lo)
    return torch.clamp(x, max=hi) if not isinstance(hi, torch.Tensor) \
        else torch.minimum(x, hi)


def tlp_score(cpu_avg_pct, cpu_valid, missing_cpu_millis,
              node_cpu_capacity_millis, pod_predicted_millis,
              target_pct: float = 40.0) -> torch.Tensor:
    """(N,) int64 TargetLoadPacking scores for one pod.

    predicted% = 100 * (measured + missing-from-cache + pod) / capacity;
    the score rises linearly from the target to 100 at the target
    utilisation, then falls to 0 at 100 %, and is 0 beyond
    (targetloadpacking.go:150-186). Nodes without metrics score 0.
    `pod_predicted_millis` is the pod's (1,) int64 prediction."""
    cap = node_cpu_capacity_millis.to(F64)
    util_millis = cpu_avg_pct / 100.0 * cap
    predicted = torch.where(
        cap != 0,
        100.0 * (util_millis + missing_cpu_millis + pod_predicted_millis)
        / torch.clamp(cap, min=1.0),
        0.0,
    )
    rising = round_half_away(
        (100.0 - target_pct) * predicted / target_pct + target_pct
    )
    falling = round_half_away(
        target_pct * (100.0 - predicted) / (100.0 - target_pct)
    )
    score = torch.where(
        predicted > target_pct,
        torch.where(predicted > 100.0, 0, falling),
        rising,
    )
    return torch.where(cpu_valid, score, 0).to(torch.int64)


def _root_power(sigma, sensitivity: float):
    """sigma^(1/sensitivity) with Go math.Pow's special cases: an exponent
    of 0.5 is Sqrt, 1 the identity and 2 a square (a generic pow may
    differ by an ulp, enough to flip an int truncation at a score edge).
    A negative sensitivity skips the root (analysis.go:48-50); 0 means
    Pow(x, +Inf)."""
    if sensitivity == 0:
        return torch.where(sigma >= 1.0, 1.0, 0.0).to(sigma.dtype)
    if sensitivity < 0:
        return sigma
    exponent = 1.0 / sensitivity
    if exponent == 1.0:
        return sigma
    if exponent == 0.5:
        return torch.sqrt(sigma)
    if exponent == 2.0:
        return sigma * sigma
    return torch.pow(sigma, exponent)


def _risk_component(avg_pct, std_pct, capacity, req, margin: float,
                    sensitivity: float) -> torch.Tensor:
    """computeScore (analysis.go:41-69) in [0, 100], float64. `req` is a
    (1,) request (any dtype) or a number."""
    cap = capacity.to(F64)
    used = _clip(avg_pct / 100.0 * cap, 0.0, cap)
    stdev = _clip(std_pct / 100.0 * cap, 0.0, cap)
    req = torch.clamp(torch.as_tensor(req, device=cap.device).to(F64),
                      min=0.0)
    mu = _clip((used + req) / torch.clamp(cap, min=1.0), 0.0, 1.0)
    sigma = _clip(stdev / torch.clamp(cap, min=1.0), 0.0, 1.0)
    sigma = _root_power(sigma, sensitivity)
    sigma = _clip(sigma * margin, 0.0, 1.0)
    risk = (mu + sigma) / 2.0
    score = (1.0 - risk) * MAX_SCORE
    return torch.where(cap > 0, score, 0.0)


def lvrb_score(metrics, node_cpu_capacity_millis, node_mem_capacity_bytes,
               pod_cpu_millis, pod_mem_bytes, margin: float = 1.0,
               sensitivity: float = 1.0) -> torch.Tensor:
    """(N,) int64 LoadVariationRiskBalancing scores: min(cpuScore,
    memScore) where both metrics exist, else the valid one's
    (loadvariationriskbalancing.go:98-121)."""
    cpu = _risk_component(metrics.cpu_avg, metrics.cpu_std,
                          node_cpu_capacity_millis, pod_cpu_millis, margin,
                          sensitivity)
    mem = _risk_component(metrics.mem_avg, metrics.mem_std,
                          node_mem_capacity_bytes, pod_mem_bytes, margin,
                          sensitivity)
    cpu = torch.where(metrics.cpu_valid, cpu, 0.0)
    mem = torch.where(metrics.mem_valid, mem, 0.0)
    both = metrics.cpu_valid & metrics.mem_valid
    total = torch.where(both, torch.minimum(cpu, mem),
                        torch.maximum(cpu, mem))
    return round_half_away(total)


# ---------------------------------------------------------------------------
# Whole-batch score curves (the batched explain rows)
# ---------------------------------------------------------------------------
#
# TLP and LVRB depend on the pod only through a scalar (the predicted CPU
# millis; the requested cpu and memory), so each node's score is a
# piecewise-linear curve in it. The per-node curve inputs are computed in
# float64, as on the per-pod path, and the (P, N) broadcast stage runs in
# float32, as JAX's does: at round-half-away knife edges a score may be 1
# off the per-pod path. The sequential solve never uses these.

#: pods per chunk of the (P, N) broadcast stage (JAX `_CURVE_CHUNK`)
_CURVE_CHUNK = 128


def _f32(value: float) -> float:
    """`value` rounded to float32, as JAX's weakly typed Python scalars
    are when they meet a float32 array."""
    return float(np.float32(value))


def _chunked_over_pods(curve_fn, pod_values) -> torch.Tensor:
    """`curve_fn((C, ...) pod rows) -> (C, N)` over chunks of
    `_CURVE_CHUNK` pods, concatenated (JAX maps it with `lax.map`)."""
    P = pod_values.shape[0]
    C = max(min(_CURVE_CHUNK, P), 1)
    return torch.cat([curve_fn(pod_values[lo:lo + C])
                      for lo in range(0, P, C)])


def _round_half_away_f32(x) -> torch.Tensor:
    """`round_half_away` in float32 and int32 (the batch stage): the same
    exact fractional-part compare as the float64 version."""
    f = torch.floor(x)
    pos = torch.where(x - f >= 0.5, f + 1, f)
    c = torch.ceil(x)
    neg = torch.where(c - x >= 0.5, c - 1, c)
    return torch.where(x >= 0, pos, neg).to(torch.int32)


def tlp_score_batch(cpu_avg_pct, cpu_valid, missing_cpu_millis,
                    node_cpu_capacity_millis, pod_predicted_millis_all,
                    target_pct: float = 40.0) -> torch.Tensor:
    """(P, N) int32 TargetLoadPacking scores for the whole batch (the
    `tlp_score` curve, targetloadpacking.go:150-186)."""
    cap = node_cpu_capacity_millis.to(F64)
    base = (cpu_avg_pct / 100.0 * cap + missing_cpu_millis).to(F32)
    inv = (100.0 / torch.clamp(cap, min=1.0)).to(F32)
    cap_zero = cap != 0
    up = _f32((100.0 - target_pct) / target_pct)
    down = _f32(target_pct / (100.0 - target_pct))
    target = _f32(target_pct)

    def curve(x_chunk):
        x = x_chunk.to(F32)[:, None]
        predicted = torch.where(cap_zero[None, :],
                                (base[None, :] + x) * inv[None, :], 0.0)
        rising = _round_half_away_f32(up * predicted + target)
        falling = _round_half_away_f32(down * (100.0 - predicted))
        score = torch.where(
            predicted > target,
            torch.where(predicted > 100.0, 0, falling),
            rising,
        )
        return torch.where(cpu_valid[None, :], score, 0)

    return _chunked_over_pods(curve, pod_predicted_millis_all)


def _risk_curve_coeffs(avg_pct, std_pct, capacity, margin: float,
                       sensitivity: float):
    """Per-node mu base and sigma in float64 (as on the per-pod path),
    demoted to the float32 coefficients of the batch stage."""
    cap = capacity.to(F64)
    used = _clip(avg_pct / 100.0 * cap, 0.0, cap)
    stdev = _clip(std_pct / 100.0 * cap, 0.0, cap)
    sigma = _clip(stdev / torch.clamp(cap, min=1.0), 0.0, 1.0)
    sigma = _root_power(sigma, sensitivity)
    sigma = _clip(sigma * margin, 0.0, 1.0)
    inv = (1.0 / torch.clamp(cap, min=1.0)).to(F32)
    return used.to(F32), inv, (50.0 * sigma).to(F32), cap > 0


def lvrb_score_batch(metrics, node_cpu_capacity_millis,
                     node_mem_capacity_bytes, pod_cpu_millis_all,
                     pod_mem_bytes_all, margin: float = 1.0,
                     sensitivity: float = 1.0) -> torch.Tensor:
    """(P, N) int32 LoadVariationRiskBalancing scores for the whole batch
    (loadvariationriskbalancing.go:98-121)."""
    c_used, c_inv, c_sig, c_pos = _risk_curve_coeffs(
        metrics.cpu_avg, metrics.cpu_std, node_cpu_capacity_millis, margin,
        sensitivity)
    m_used, m_inv, m_sig, m_pos = _risk_curve_coeffs(
        metrics.mem_avg, metrics.mem_std, node_mem_capacity_bytes, margin,
        sensitivity)
    both = metrics.cpu_valid & metrics.mem_valid
    pods2 = torch.stack([
        torch.clamp(pod_cpu_millis_all.to(F32), min=0.0),
        torch.clamp(pod_mem_bytes_all.to(F32), min=0.0),
    ], dim=1)

    def component(req, used, inv, half_sig, pos):
        mu = _clip((used[None, :] + req) * inv[None, :], 0.0, 1.0)
        score = 100.0 - 50.0 * mu - half_sig[None, :]
        return torch.where(pos[None, :], score, 0.0)

    def curve(chunk):
        cpu = component(chunk[:, 0:1], c_used, c_inv, c_sig, c_pos)
        mem = component(chunk[:, 1:2], m_used, m_inv, m_sig, m_pos)
        cpu = torch.where(metrics.cpu_valid[None, :], cpu, 0.0)
        mem = torch.where(metrics.mem_valid[None, :], mem, 0.0)
        total = torch.where(both[None, :], torch.minimum(cpu, mem),
                            torch.maximum(cpu, mem))
        return _round_half_away_f32(total)

    return _chunked_over_pods(curve, pods2)


# ---------------------------------------------------------------------------
# LowRiskOverCommitment
# ---------------------------------------------------------------------------

MAX_VARIANCE_ALLOWANCE = 0.99  # lowriskovercommitment.go:47
_TINY = float(np.finfo(np.float64).tiny)
#: the continued fraction's tolerance and its floor (float64 eps / 2),
#: its iteration bound, and the small-`a` switch of the prefactor: the
#: float64 constants of JAX's `regularized_incomplete_beta_impl`
_CF_SMALL = float(np.finfo(np.float64).eps / 2)
_CF_ITERATIONS = 600
_VERY_SMALL = float(np.finfo(np.float64).tiny * 2)


def _cf_numerator(it: int, a, ab, b, x):
    """The continued fraction's partial numerator at iteration `it`
    (dlmf 8.17.E23, `ab` = a + b): 1 at the first; its even and odd terms
    with the values and operation order of JAX's
    `nth_partial_betainc_numerator`."""
    if it == 1:
        return torch.ones_like(x)
    m = float((it - 1) // 2)
    a2m = a + 2.0 * m
    if it % 2 == 0:
        if m == 0:
            return -ab * x / (a + 1.0)
        return -(a + m) * (ab + m) * x / (a2m * (a2m + 1.0))
    return m * (b - m) * x / ((a2m - 1.0) * a2m)


def _continued_fraction(a, b, x):
    """The modified Lentz evaluation of JAX's
    `lentz_thompson_barnett_algorithm` for the incomplete beta, row by row
    over the last axis: up to 599 iterations, a row stopping once none of
    its elements' steps changes its value by eps / 2 or more (JAX stops
    its whole array there; a row here is one JAX call). A stopped row is
    frozen by a device flag. On the CPU the loop exits once every row has
    stopped (reading the flags is no sync there); on the card it reads
    nothing on the host and runs out its bound, with the same values."""
    small = _CF_SMALL
    ab = a + b
    h = torch.full_like(x, small)  # the 0th denominator, 0, is below small
    C, D, H = h, torch.zeros_like(x), h
    active = torch.ones(x.shape[:-1] + (1,), dtype=torch.bool,
                        device=x.device)
    on_cpu = x.device.type == "cpu"
    for it in range(1, _CF_ITERATIONS):
        pn = _cf_numerator(it, a, ab, b, x)
        c = 1.0 + pn / C
        c = torch.where(torch.abs(c) < small, small, c)
        d = 1.0 + pn * D
        d = torch.where(torch.abs(d) < small, small, d)
        d = torch.reciprocal(d)
        delta = c * d
        C = torch.where(active, c, C)
        D = torch.where(active, d, D)
        H = torch.where(active, H * delta, H)
        active = active & (torch.abs(delta - 1.0) >= small).any(
            dim=-1, keepdim=True)
        if on_cpu and not bool(active.any()):
            break
    return H


def betainc(a, b, x) -> torch.Tensor:
    """The regularized incomplete beta function I_x(a, b), float64, as
    `jax.scipy.special.betainc` computes it over each row (the last axis)
    of the inputs: the continued fraction on the side of (a + 1) /
    (a + b + 2) where it converges fast (the symmetry relation on the
    other), times exp(a log x + b log1p(-x) - log B(a, b)) / a, with JAX's
    0, 1 and NaN edge cases. A 1-D input is one JAX call, a 0-d one too."""
    if x.dim() == 0:
        return betainc(a[None], b[None], x[None])[0]
    inf = math.inf
    a_is_zero = (a == 0) | (b == inf)
    b_is_zero = (b == 0) | (a == inf)
    x_is_zero = x == 0
    x_is_one = x == 1
    is_nan = torch.isnan(a) | torch.isnan(b) | torch.isnan(x)
    result_is_zero = (b_is_zero & ~x_is_one) | (a_is_zero & x_is_zero)
    result_is_one = (a_is_zero & ~x_is_zero) | (b_is_zero & x_is_one)
    result_is_nan = ((a < 0) | (b < 0) | (x < 0) | (x > 1)
                     | (a_is_zero & b_is_zero) | is_nan)

    converges_rapidly = x < (a + 1.0) / (a + b + 2.0)
    a, b = (torch.where(converges_rapidly, a, b),
            torch.where(converges_rapidly, b, a))
    x = torch.where(converges_rapidly, x, 1.0 - x)
    cf = _continued_fraction(a, b, x)
    lbeta_ab_small_a = torch.lgamma(b) - torch.lgamma(a + b)
    lbeta_ab = torch.lgamma(a) + lbeta_ab_small_a
    factor = torch.where(
        a < _VERY_SMALL,
        torch.exp(torch.log1p(-x) * b - lbeta_ab_small_a),
        torch.exp(torch.log(x) * a + torch.log1p(-x) * b - lbeta_ab) / a,
    )
    result = cf * factor
    result = torch.where(converges_rapidly, result, 1.0 - result)
    result = torch.where(result_is_zero, 0.0, result)
    result = torch.where(result_is_one, 1.0, result)
    return torch.where(result_is_nan, math.nan, result)


def _beta_cdf(threshold, alpha, beta_p, valid):
    """DistributionFunction (beta.go:80-104): I_x(a, b) with x == 0 -> 0
    and x == 1 -> 1; an invalid fit evaluates beta(1, 1) there. Rows of
    the last axis are separate evaluations (see `betainc`)."""
    x = _clip(threshold, 0.0, 1.0)
    safe_a = torch.where(valid, alpha, 1.0)
    safe_b = torch.where(valid, beta_p, 1.0)
    cdf = betainc(safe_a, safe_b, x)
    return torch.where(x <= 0.0, 0.0, torch.where(x >= 1.0, 1.0, cdf))


def _moment_fit(mu, sigma, threshold):
    """MatchMoments (beta.go:107-117) and ComputeProbability's degenerate
    cases: (fit_valid, alpha, beta, degenerate_one, degenerate_zero)."""
    m1 = mu
    variance = sigma * sigma
    fit_valid = ((m1 >= 0.0) & (m1 <= 1.0) & (variance >= 0.0)
                 & (variance < m1 * (1.0 - m1)))
    temp = torch.clamp(
        m1 * (1.0 - m1) / torch.clamp(variance, min=_TINY) - 1.0, min=_TINY
    )
    alpha = m1 * temp
    beta_p = (1.0 - m1) * temp
    degenerate_one = (mu == 0.0) | ((sigma == 0.0) & (mu <= threshold))
    degenerate_zero = (sigma == 0.0) & (mu > threshold)
    fit_valid = fit_valid & ~degenerate_one & ~degenerate_zero
    return fit_valid, alpha, beta_p, degenerate_one, degenerate_zero


def _probability(cdf, fit_valid, degenerate_one, degenerate_zero):
    """ComputeProbability's result from the fitted CDF (beta.go:174-191):
    a NaN CDF reads 1."""
    cdf = torch.where(torch.isnan(cdf), 1.0, cdf)
    return torch.where(
        degenerate_one, 1.0,
        torch.where(degenerate_zero, 0.0,
                    torch.where(fit_valid, cdf, 0.0)),
    )


def compute_probability(mu, sigma, threshold):
    """ComputeProbability (beta.go:174-191): P[util <= threshold] under a
    beta distribution moment-matched to (mu, sigma). Returns (prob,
    fit_valid, alpha, beta); fit_valid mirrors `fitDistribution != nil`
    for the conditioning step."""
    fit_valid, alpha, beta_p, one, zero = _moment_fit(mu, sigma, threshold)
    cdf = _beta_cdf(threshold, alpha, beta_p, fit_valid)
    return _probability(cdf, fit_valid, one, zero), fit_valid, alpha, beta_p


def _risk_inputs(avg_pct, std_pct, capacity, node_req, node_limit,
                 node_req_minus_pod, node_limit_minus_pod,
                 smoothing_window: int) -> dict:
    """computeRisk's quantities before its two beta CDFs
    (lowriskovercommitment.go:173-231), float64 over the nodes: the
    overcommit potential, the smoothed (mu, sigma), the allocation and
    limit thresholds, and the moment fit."""
    cap = capacity.to(F64)
    req = node_req.to(F64)
    limit = node_limit.to(F64)
    req_minus = node_req_minus_pod.to(F64)
    limit_minus = node_limit_minus_pod.to(F64)
    # (1) riskLimit: overcommit potential
    risk_limit = torch.where(
        limit > cap,
        (limit - cap) / torch.clamp(limit - req, min=_TINY),
        0.0,
    )
    # (2) riskLoad: measured overcommitment through the beta fit
    used = _clip(avg_pct / 100.0 * cap, 0.0, cap)
    stdev = _clip(std_pct / 100.0 * cap, 0.0, cap)
    mu = _clip(used / torch.clamp(cap, min=1.0), 0.0, 1.0)
    sigma = _clip(stdev / torch.clamp(cap, min=1.0), 0.0, 1.0)
    sigma = sigma * math.sqrt(float(smoothing_window))
    max_var = torch.where((mu > 0.0) & (mu < 1.0), mu * (1.0 - mu), 0.0)
    sigma = torch.minimum(sigma,
                          torch.sqrt(max_var * MAX_VARIANCE_ALLOWANCE))
    alloc_threshold = _clip(req_minus / torch.clamp(cap, min=1.0), 0.0, 1.0)
    fit = _moment_fit(mu, sigma, alloc_threshold)
    return dict(
        cap=cap, risk_limit=risk_limit, fit=fit,
        alloc_threshold=alloc_threshold,
        limit_threshold=limit_minus / torch.clamp(cap, min=1.0),
        # conditioning when limits do not overcommit
        # (lowriskovercommitment.go:232-245)
        conditioned=(limit_minus < cap) & (req_minus <= limit_minus),
    )


def _risk_total(inputs: dict, alloc_cdf, limit_prob, valid,
                risk_limit_weight: float):
    """computeRisk's end (lowriskovercommitment.go:232-256) from the two
    beta CDFs: the conditioned allocation probability, the load risk and
    the weighted total, clipped to [0, 1]."""
    fit_valid = inputs["fit"][0]
    alloc_prob = _probability(alloc_cdf, fit_valid, *inputs["fit"][3:])
    cond_prob = torch.where(
        inputs["limit_threshold"] == 0.0,
        1.0,
        torch.where(
            fit_valid & (limit_prob > 0.0),
            _clip(alloc_prob / torch.clamp(limit_prob, min=_TINY), 0.0, 1.0),
            alloc_prob,
        ),
    )
    alloc_prob = torch.where(inputs["conditioned"], cond_prob, alloc_prob)
    risk_load = torch.where(valid, 1.0 - alloc_prob, 0.0)
    total = (risk_limit_weight * inputs["risk_limit"]
             + (1.0 - risk_limit_weight) * risk_load)
    return _clip(total, 0.0, 1.0)


def _cdf_rows(inputs: dict):
    """The (2, N) threshold, alpha, beta and validity rows of a
    resource's two beta CDFs: the allocation and the limit threshold
    under the same fit."""
    fit_valid, alpha, beta_p = inputs["fit"][:3]
    return (torch.stack([inputs["alloc_threshold"],
                         inputs["limit_threshold"]]),
            torch.stack([alpha, alpha]), torch.stack([beta_p, beta_p]),
            torch.stack([fit_valid, fit_valid]))


def _risk_one_resource(avg_pct, std_pct, valid, capacity, node_req,
                       node_limit, node_req_minus_pod, node_limit_minus_pod,
                       smoothing_window: int, risk_limit_weight: float):
    """computeRisk (lowriskovercommitment.go:173-256) for one resource
    over the nodes. Quantities are int64 in native units."""
    inputs = _risk_inputs(avg_pct, std_pct, capacity, node_req, node_limit,
                          node_req_minus_pod, node_limit_minus_pod,
                          smoothing_window)
    cdf = _beta_cdf(*_cdf_rows(inputs))
    return _risk_total(inputs, cdf[0], cdf[1], valid, risk_limit_weight)


def lroc_score(metrics, node_cpu_capacity, node_mem_capacity, node_req_cpu,
               node_req_mem, node_limit_cpu, node_limit_mem, pod_req_cpu,
               pod_req_mem, pod_limit_cpu, pod_limit_mem,
               smoothing_window: int = 5, risk_limit_weight_cpu: float = 0.5,
               risk_limit_weight_mem: float = 0.5) -> torch.Tensor:
    """(N,) int64 LowRiskOverCommitment scores: round((1 - max(riskCPU,
    riskMem)) * 100).

    node_req_* / node_limit_* EXCLUDE the pending pod (the minus-pod
    values); the with-pod sums are formed here, with requests capped at
    capacity (resourcestats.go:163-225). The four beta CDFs (allocation
    and limit, cpu and memory) are one (4, N) evaluation, each row its
    own continued fraction as in JAX's four calls."""
    req_cpu = torch.minimum(node_req_cpu + pod_req_cpu, node_cpu_capacity)
    req_mem = torch.minimum(node_req_mem + pod_req_mem, node_mem_capacity)
    req_cpu_minus = torch.minimum(node_req_cpu, node_cpu_capacity)
    req_mem_minus = torch.minimum(node_req_mem, node_mem_capacity)
    # the pending pod's limits are clamped to >= its requests, like every
    # other pod's (SetMaxLimits in CreatePodResourcesStateData)
    limit_cpu = node_limit_cpu + torch.maximum(pod_limit_cpu, pod_req_cpu)
    limit_mem = node_limit_mem + torch.maximum(pod_limit_mem, pod_req_mem)

    cpu = _risk_inputs(metrics.cpu_avg, metrics.cpu_std, node_cpu_capacity,
                       req_cpu, limit_cpu, req_cpu_minus, node_limit_cpu,
                       smoothing_window)
    mem = _risk_inputs(metrics.mem_avg, metrics.mem_std, node_mem_capacity,
                       req_mem, limit_mem, req_mem_minus, node_limit_mem,
                       smoothing_window)
    rows = [torch.cat(pair) for pair in zip(_cdf_rows(cpu), _cdf_rows(mem))]
    cdf = _beta_cdf(*rows)
    risk_cpu = _risk_total(cpu, cdf[0], cdf[1], metrics.cpu_valid,
                           risk_limit_weight_cpu)
    risk_mem = _risk_total(mem, cdf[2], cdf[3], metrics.mem_valid,
                           risk_limit_weight_mem)
    rank = 1.0 - torch.maximum(risk_cpu, risk_mem)
    return round_half_away(rank * MAX_SCORE)


def peaks_score(cpu_avg_pct, cpu_valid, node_cpu_capacity_millis,
                pod_cpu_millis, k1, k2) -> torch.Tensor:
    """(N,) int64 Peaks raw scores: the power jump to minimize, scaled by
    1e15 and truncated to int64 (saturating, as XLA converts;
    peaks.go:103-146). A predicted utilisation over 100 % or missing
    metrics score MinNodeScore."""
    cap = node_cpu_capacity_millis.to(F64)
    util_millis = cpu_avg_pct / 100.0 * cap
    predicted = torch.where(
        cap != 0,
        100.0 * (util_millis + pod_cpu_millis) / torch.clamp(cap, min=1.0),
        0.0,
    )
    jump = k1 * (torch.exp(k2 * predicted) - torch.exp(k2 * cpu_avg_pct))
    score = saturating_int64(torch.trunc(jump * 1e15))
    return torch.where(cpu_valid & (predicted <= 100.0), score, 0)
