"""Hyperparameter fit of the 6-dim LEMoN score
(port of lemon_tpu/scoring/optimize.py).

Reference strategy (lib/metrics/utils.py:151-196): the best of
 (a) scipy Powell and Nelder-Mead from 4 starts on the true F1 objective,
 (b) L-BFGS on a differentiable SoftMarginLoss proxy from the same starts,
 (c) an 8,000-point grid (run_lemon.py:332-337).

The strict path (``use_device_grid=False``, ``--strict_hparam_parity``) is
the JAX package's unchanged: host scipy, the torch ``_proxy_lbfgs`` per
restart, then every grid point under the caller's objective on the host.

The default path runs all proxy restarts as one batched L-BFGS on the
device (:func:`proxy_lbfgs_device_batch`, optax's ``lbfgs`` with Armijo
backtracking as the JAX package runs it), scores the whole grid on the
device (``scores_grid`` per batch of grid rows, then an exact
all-thresholds F1 sweep, :func:`grid_best_f1_device`), re-ranks the top 8
under the caller's objective and polishes the best candidate with one host
Powell run.
"""

from __future__ import annotations

from itertools import product
from typing import Callable, Dict, Iterable, Sequence, Tuple

import numpy as np
import torch
from scipy.optimize import minimize

from lemon_tpu_torch.core.profiling import PhaseTimer
from lemon_tpu_torch.scoring.lemon import (
    HPARAM_ORDER,
    NeighborLogs,
    calc_scores,
    component_tensors,
    scores_grid,
    soft_margin_proxy_loss,
    unpack_hparams,
)
from lemon_tpu_torch.scoring.thresholds import optimize_f1_efficient


def default_grid() -> Dict[str, Sequence[float]]:
    """The run_lemon grid (run_lemon.py:332-337); tau_1/tau_2 are shared by
    the _n and _m variants."""
    return {
        "beta": np.arange(0, 100.01, 5),
        "gamma": np.arange(0, 100.01, 5),
        "tau_1": [0, 1, 5, 10],
        "tau_2": [0, 1, 5, 10],
    }


def grid_to_matrix(grid: Dict[str, Sequence[float]], force_zero=(), force_one=()) -> np.ndarray:
    """A named grid -> (G, 6) matrix in HPARAM_ORDER; shared taus map to both
    variants and ablated coordinates are pinned in the matrix itself
    (lemon_tpu/scoring/optimize.py:52-82)."""
    keys = list(grid.keys())
    rows = []
    for combo in product(*[grid[k] for k in keys]):
        named = dict(zip(keys, combo))
        row = []
        for name in HPARAM_ORDER:
            if name in named:
                v = named[name]
            elif name in ("tau_1_n", "tau_1_m"):
                v = named["tau_1"]
            elif name in ("tau_2_n", "tau_2_m"):
                v = named["tau_2"]
            else:
                raise KeyError(name)
            if name in force_zero:
                v = 0.0
            elif name in force_one:
                v = 1.0
            row.append(v)
        rows.append(row)
    return np.asarray(rows, dtype=np.float64)


def _best_f1_rows(scores: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Exact max-over-thresholds F1 for each row of (G, N) scores: sort, a
    cumulative true-positive count, and only cuts between distinct scores."""
    n = scores.shape[1]
    s_sorted, order = torch.sort(scores, dim=1, descending=True, stable=True)
    tp = torch.cumsum(y[order], dim=1)
    pred_pos = torch.arange(1, n + 1, dtype=scores.dtype, device=scores.device)[None, :]
    f1 = 2.0 * tp / (pred_pos + y.sum())
    realizable = torch.cat(
        [s_sorted[:, :-1] > s_sorted[:, 1:], torch.ones_like(s_sorted[:, :1], dtype=torch.bool)], dim=1
    )
    return torch.where(realizable, f1, torch.full_like(f1, -1.0)).amax(dim=1)


def grid_best_f1_device(logs: NeighborLogs, y: np.ndarray, grid_matrix: np.ndarray, device: torch.device, batch: int = 128) -> np.ndarray:
    """F1 at the optimal threshold for every grid point, on ``device``."""
    comps = component_tensors(logs, device)
    y_dev = torch.as_tensor(np.asarray(y, np.float32), device=device)
    g = torch.as_tensor(np.asarray(grid_matrix, np.float32), device=device)
    out = [_best_f1_rows(scores_grid(comps, g[s : s + batch]), y_dev) for s in range(0, len(g), batch)]
    return torch.cat(out).cpu().numpy()


def _objective(x, logs: NeighborLogs, y, obj_func: Callable, obj_args: dict, force_zero, force_one) -> float:
    h = unpack_hparams(x, force_zero, force_one)
    with np.errstate(over="ignore", invalid="ignore"):
        score = calc_scores(logs, h)
    if not np.all(np.isfinite(score)):
        # extreme tau/beta candidates overflow exp(): maximally bad
        return np.inf
    return -obj_func(y, score, **obj_args)


def _proxy_lbfgs(logs: NeighborLogs, y: np.ndarray, x0, force_zero, force_one) -> np.ndarray:
    """Strict-parity proxy stage: torch LBFGS with the reference's configuration — lr=0.1,
    max_iter=20, strong_wolfe, the step() loop run 20 times (torch_minimize,
    lib/metrics/utils.py:129-141) — on the SoftMarginLoss proxy
    (optim_func_torch, :124-127). Host CPU, copied from
    lemon_tpu/scoring/optimize.py:196-249, including the reference's dtype
    mix: d_1 float64, the neighbour matrices float32."""
    k = logs.dists_n.shape[1]
    d1 = torch.tensor(np.asarray(logs.d_1, np.float64))
    dists_n, D_n, dtr_n = (torch.tensor(a) for a in (logs.dists_n, logs.D_n, logs.dists_tr_n))
    dists_m, D_m, dtr_m = (torch.tensor(a) for a in (logs.dists_m, logs.D_m, logs.dists_tr_m))
    y_signed = torch.from_numpy(np.asarray(y)).double() * 2 - 1
    fz = [i for i, name in enumerate(HPARAM_ORDER) if name in force_zero]
    fo = [i for i, name in enumerate(HPARAM_ORDER) if name in force_one]

    x = torch.tensor(np.asarray(x0, np.float64), dtype=torch.float64, requires_grad=True)
    optimizer = torch.optim.LBFGS([x], lr=0.1, max_iter=20, line_search_fn="strong_wolfe")

    def loss_fn():
        h = list(x)
        for i in fz:
            h[i] = torch.zeros(())
        for i in fo:
            h[i] = torch.ones(())
        beta, gamma, t1n, t2n, t1m, t2m = h
        wn = torch.exp(-t1n * D_n) * torch.exp(-t2n * dtr_n)
        wm = torch.exp(-t1m * D_m) * torch.exp(-t2m * dtr_m)
        score = d1 + beta * torch.sum(wn * dists_n, dim=1) / k + gamma * torch.sum(wm * dists_m, dim=1) / k
        return torch.nn.SoftMarginLoss()(score, y_signed)

    def closure():
        optimizer.zero_grad()
        loss = loss_fn()
        loss.backward()
        return loss

    for _ in range(20):
        optimizer.step(closure)
    return x.detach().numpy()


# optax 0.2.6 defaults: lbfgs(memory_size=10, scale_init_precond=True),
# scale_by_backtracking_linesearch(slope_rtol=1e-4, decrease_factor=0.8,
# increase_factor=1.5, max_learning_rate=1.0, atol=0, rtol=0)
LBFGS_MEMORY = 10
LS_MAX_STEPS = 15
LS_SLOPE_RTOL = 1e-4
LS_DECREASE = 0.8
LS_INCREASE = 1.5
LS_MAX_LR = 1.0


def _value_and_grad(fn, x: torch.Tensor):
    """Per-row values of ``fn`` and their gradients: rows are independent,
    so the gradient of the sum is the stack of the rows' gradients."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        value = fn(xg)
        (grad,) = torch.autograd.grad(value.sum(), xg)
    return value.detach(), grad


def _rowdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(dim=1)


def proxy_lbfgs_device_batch(x0s: torch.Tensor, comps, y_signed: torch.Tensor, fz: torch.Tensor, fo: torch.Tensor, maxiter: int = 100) -> torch.Tensor:
    """Every proxy restart as one row of batched tensors on their device
    (port of lemon_tpu/scoring/optimize.py:124-174).

    ``x0s`` (R, 6) float32 start points, ``comps`` the float32 score
    components, ``y_signed`` (N,) in {-1, 1}, ``fz`` / ``fo`` (6,) bool
    ablation masks. Each row runs ``maxiter`` steps of optax 0.2.6's
    ``lbfgs`` (memory 10, the first step scaled to a unit-norm direction,
    later ones by the last curvature pair) under
    ``scale_by_backtracking_linesearch(max_backtracking_steps=15,
    store_grad=True)``, whose value and gradient at the accepted point are
    reused by the next step. A row's line search takes its first trial step
    with sufficient decrease (Armijo), else its 16th; one that never finds a
    finite value takes no step. The 16 trials of all rows are one batched
    evaluation. Autograd gives the gradient; no ``torch.optim``.
    Returns the (R, 6) candidates clipped to +-100, with a non-finite row
    replaced by its start point."""

    def loss(x):
        return soft_margin_proxy_loss(x, comps, y_signed, fz, fo)

    x = x0s.clone()
    r = x.shape[0]
    s_mem = x.new_zeros((LBFGS_MEMORY, r, 6))  # parameter differences
    y_mem = x.new_zeros((LBFGS_MEMORY, r, 6))  # gradient differences
    rho = x.new_zeros((LBFGS_MEMORY, r))
    prev_x, prev_g = torch.zeros_like(x), torch.zeros_like(x)
    ls_lr = x.new_ones(r)
    ls_value = x.new_full((r,), torch.inf)
    ls_grad = torch.zeros_like(x)
    for count in range(maxiter):
        # value_and_grad_from_state: reuse the line search's last point
        # unless its value is not finite
        stale = ~torch.isfinite(ls_value)
        value, grad = ls_value, ls_grad
        if bool(stale.any()):
            v, g = _value_and_grad(loss, x)
            value = torch.where(stale, v, value)
            grad = torch.where(stale[:, None], g, grad)

        # scale_by_lbfgs: store the newest curvature pair, then the
        # two-loop product with the memory (oldest pairs are zero at first)
        mi, pmi = count % LBFGS_MEMORY, (count - 1) % LBFGS_MEMORY
        if count > 0:
            dp, du = x - prev_x, grad - prev_g
            vd = _rowdot(du, dp)
            w = torch.where(vd == 0.0, torch.zeros_like(vd), 1.0 / vd)
            den = _rowdot(du, du)
            scale = torch.where(den > 0.0, vd / den, torch.ones_like(den))
        else:
            dp, du, w = torch.zeros_like(x), torch.zeros_like(x), x.new_zeros(r)
            scale = torch.clamp(1.0 / torch.linalg.vector_norm(grad, dim=1), max=1.0)
        s_mem[pmi], y_mem[pmi], rho[pmi] = dp, du, w
        direction = grad
        alphas = [None] * LBFGS_MEMORY
        for i in reversed(range(LBFGS_MEMORY)):
            j = (mi + i) % LBFGS_MEMORY
            alphas[i] = rho[j] * _rowdot(s_mem[j], direction)
            direction = direction - alphas[i][:, None] * y_mem[j]
        direction = scale[:, None] * direction
        for i in range(LBFGS_MEMORY):
            j = (mi + i) % LBFGS_MEMORY
            beta = rho[j] * _rowdot(y_mem[j], direction)
            direction = direction + (alphas[i] - beta)[:, None] * s_mem[j]
        prev_x, prev_g = x, grad
        direction = -direction

        # scale_by_backtracking_linesearch. Its trial step sizes lr, 0.8 lr,
        # 0.8^2 lr, ... are evaluated in one batch, and each row takes the
        # first with sufficient decrease, else the last: the trials the
        # sequential search would stop at, without one host sync per trial
        slope = _rowdot(direction, grad)
        lrs = [torch.clamp(LS_INCREASE * ls_lr, max=LS_MAX_LR)]
        for _ in range(LS_MAX_STEPS):
            lrs.append(lrs[-1] * LS_DECREASE)
        lrs = torch.stack(lrs)  # (T, R)
        t = lrs.shape[0]
        v, g = _value_and_grad(loss, (x + lrs[:, :, None] * direction).reshape(t * r, 6))
        v, g = v.view(t, r), g.view(t, r, 6)
        error = v - value - lrs * LS_SLOPE_RTOL * slope
        error = torch.clamp(torch.where(torch.isnan(error), torch.full_like(error, torch.inf), error), min=0.0)
        done = error <= 0.0
        pick = torch.where(done.any(dim=0), done.to(torch.int8).argmax(dim=0), t - 1)[None]  # (1, R)
        lr, ls_value, error = lrs.gather(0, pick)[0], v.gather(0, pick)[0], error.gather(0, pick)[0]
        ls_grad = g.gather(0, pick[:, :, None].expand(1, r, 6))[0]
        # a search that found no finite value takes no step
        ls_lr = torch.where(torch.isinf(error), torch.zeros_like(lr), lr)
        x = x + ls_lr[:, None] * direction

    xf = x.clamp(-100.0, 100.0)
    return torch.where(torch.isfinite(xf).all(dim=1, keepdim=True), xf, x0s)


def maximize_metric(
    logs_val: NeighborLogs,
    grid: Dict[str, Sequence[float]] | None = None,
    x0s: Iterable[Sequence[float]] = ((0,) * 6, (0.5,) * 6, (1,) * 6, (10,) * 6),
    obj_func: Callable = optimize_f1_efficient,
    obj_func_args: dict | None = None,
    force_zero: Sequence[str] = (),
    force_one: Sequence[str] = (),
    scipy_methods: Sequence[str] = ("Powell", "Nelder-Mead"),
    use_device_grid: bool = True,
    device: torch.device = torch.device("cpu"),
    timer: PhaseTimer | None = None,
) -> Tuple[np.ndarray, float, float]:
    """(best 6-vector, best objective value, threshold at the optimum);
    signature and ensemble semantics of lib/metrics/utils.py:151-196."""
    timer = timer or PhaseTimer(device)
    obj_func_args = obj_func_args or {}
    grid = grid if grid is not None else default_grid()
    y = np.asarray(logs_val.is_mislabel)
    args = (logs_val, y, obj_func, obj_func_args, force_zero, force_one)

    best_x: np.ndarray | None = None
    best_val = -1.0

    def consider(x):
        nonlocal best_x, best_val
        val = -_objective(x, *args)
        if val > best_val:
            best_val = val
            best_x = np.asarray(x, np.float64)

    if not use_device_grid:
        # strict parity: every (x0, method) pair under the true objective
        with timer.phase("hparam_scipy"):
            for x0 in x0s:
                for method in scipy_methods:
                    res = minimize(_objective, np.asarray(x0, np.float64), args=args, method=method, options={})
                    if -res.fun > best_val:
                        best_val = float(-res.fun)
                        best_x = res.x

    with timer.phase("hparam_proxy_lbfgs"):
        x0_list = list(x0s)
        if use_device_grid and x0_list:
            comps = component_tensors(logs_val, device)
            y_signed = torch.as_tensor(np.asarray(y, np.float32) * 2 - 1, device=device)
            fz = torch.tensor([name in force_zero for name in HPARAM_ORDER], device=device)
            fo = torch.tensor([name in force_one for name in HPARAM_ORDER], device=device)
            x0_mat = torch.as_tensor(np.asarray(x0_list, np.float32), device=device)
            for cand in proxy_lbfgs_device_batch(x0_mat, comps, y_signed, fz, fo).cpu().numpy().astype(np.float64):
                consider(cand)
        else:
            for x0 in x0_list:
                consider(_proxy_lbfgs(logs_val, y, x0, force_zero, force_one))

    gm = grid_to_matrix(grid, force_zero=force_zero, force_one=force_one)
    with timer.phase("hparam_grid"):
        if use_device_grid:
            f1s = grid_best_f1_device(logs_val, y, gm, device)
            # re-rank the leaders under the caller's objective, whose
            # threshold search can order near-ties differently
            for row_idx in np.argsort(-f1s)[:8]:
                consider(gm[int(row_idx)])
        else:
            for row in gm:
                consider(row)

    if best_x is None:
        raise RuntimeError("hyperparameter search produced no candidate")

    if use_device_grid:
        # one true-objective local refinement of the best candidate
        with timer.phase("hparam_scipy"):
            res = minimize(_objective, np.asarray(best_x, np.float64), args=args, method="Powell", options={})
            if -res.fun > best_val:
                best_val = float(-res.fun)
                best_x = res.x

    for c, name in enumerate(HPARAM_ORDER):
        if name in force_zero:
            best_x[c] = 0.0
        if name in force_one:
            best_x[c] = 1.0

    score = calc_scores(logs_val, unpack_hparams(best_x, force_zero, force_one))
    _, thres = obj_func(y, score, return_thres=True, **obj_func_args)
    return best_x, best_val, thres
