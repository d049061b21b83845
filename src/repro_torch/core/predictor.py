"""Jiagu's prediction model (paper §4.1): Random Forest Regression,
from scratch.

    P_{A | {B, C, ...}} = RFR{P_A, R_A, C_A, R_B, C_B, R_C, C_C, ...}

Function-granularity inputs (the paper's dimensionality-reduction insight):
instances of one function are homogeneous, so neighbor features are merged
into concurrency-weighted aggregates instead of per-instance columns —
input size is O(1) in the number of colocated instances:

    x = [ P_A, R_A (13), C_A^sat, C_A^cached,
          sum_B C_B^sat * R_B (13), sum_B C_B^sat, sum_B C_B^cached ]   (31,)

Training is plain numpy CART (variance-reduction splits, bootstrap rows,
sqrt-feature bagging) — profiling/training nodes are offline, so training
cost is off the scheduling path.  Inference has three engines
(``INFERENCE_ENGINES``):

  * ``numpy`` — vectorized level-synchronous descent (the host oracle),
  * ``torch`` — the plain PyTorch descent on the forest's device,
  * ``cuda``  — the hand-written forest kernel
                (``repro_torch.kernels.rfr_inference``), the hot path.

The forest is flattened to *complete* depth-D arrays so all engines share
one layout, and all three compute bitwise the same predictions.  A forest
fitted elsewhere (the reference's ``ForestArrays``) is carried across
with ``RandomForestRegressor.load_arrays`` or ``forest_from_numpy``.
Also ships the Fig-16 comparison zoo (linear/ridge/ESP-style quadratic
ridge/GBT/MLP-2,3,4).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .profiles import N_PROFILE

N_FEATURES = 1 + N_PROFILE + 2 + N_PROFILE + 2  # 31

#: forest inference engines: the numpy host oracle, the plain PyTorch
#: version, and the hand-written CUDA kernel
INFERENCE_ENGINES = ("numpy", "torch", "cuda")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    names another.  Raises when the card is asked for and there is none
    — the port never continues quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' (engine 'torch') or "
            "engine='numpy' to run on the host")
    return dev


def forest_from_numpy(feat: np.ndarray, thr: np.ndarray, leaf: np.ndarray,
                      device=None) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """The complete-tree forest arrays (numpy, e.g. the reference's
    ``ForestArrays``) as contiguous (feat int32, thr f32, leaf f32)
    tensors on `device` — the arguments of ``kernels.ops.rfr_op``."""
    dev = resolve_device(device)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)
                 for a, dt in ((feat, np.int32), (thr, np.float32),
                               (leaf, np.float32)))


def build_features(solo_lat: float, profile: np.ndarray, n_sat: float,
                   n_cached: float,
                   neighbors: Sequence[Tuple[np.ndarray, float, float]]
                   ) -> np.ndarray:
    """Feature vector for one (target function, colocation) scenario.
    neighbors: [(profile, ns, nc), ...] NOT including the target.

    The aggregate block is the *node-level* concurrency-weighted profile
    sum INCLUDING the target's own instances: trees split on thresholds
    and cannot form the product n_sat x profile themselves, so giving
    them pre-multiplied total pressure is what makes capacity sweeps
    (m = 1..m_max with everything else fixed) resolvable."""
    agg = profile * n_sat
    tot_sat, tot_cached = float(n_sat), float(n_cached)
    for prof, ns, nc in neighbors:
        agg += prof * ns
        tot_sat += ns
        tot_cached += nc
    return np.concatenate([
        [solo_lat], profile, [n_sat, n_cached], agg, [tot_sat, tot_cached],
    ]).astype(np.float32)


# ---------------------------------------------------------------------------
# CART regression tree
# ---------------------------------------------------------------------------


class _CART:
    """Greedy variance-reduction regression tree, flattened on build to
    complete-tree arrays (feat, thr over 2^D-1 internal nodes; 2^D leaves).
    Unsplit subtrees are filled with always-go-left sentinels."""

    def __init__(self, max_depth: int = 8, min_samples_leaf: int = 2,
                 max_features: Optional[int] = None, rng=None):
        self.D = max_depth
        self.min_leaf = min_samples_leaf
        self.max_features = max_features
        self.rng = rng or np.random.default_rng()
        NN = (1 << self.D) - 1
        self.feat = np.zeros(NN, np.int32)
        self.thr = np.full(NN, np.inf, np.float32)
        self.leaf = np.zeros(1 << self.D, np.float32)

    def fit(self, X: np.ndarray, y: np.ndarray):
        self._X, self._y = X, y.astype(np.float64)
        self._build(np.arange(len(y)), 0, 0)
        del self._X, self._y
        return self

    def _best_split(self, idx):
        X, y = self._X[idx], self._y[idx]
        n, F = X.shape
        # sklearn's RandomForestRegressor default is max_features=1.0 (all
        # features) for regression — bootstrap rows provide the ensemble
        # diversity.  sqrt-bagging here measurably breaks the uncontended
        # corner (solo-run rows average into interference-heavy leaves).
        k = self.max_features or F
        feats = self.rng.choice(F, size=min(k, F), replace=False)
        total = y.sum()
        sq = (y ** 2).sum()
        best = (None, 0.0, 0.0)  # (feature, threshold, gain)
        base = sq - total * total / n
        for f in feats:
            order = np.argsort(X[:, f], kind="stable")
            xs, ys = X[order, f], y[order]
            cl = np.cumsum(ys)[:-1]
            cl2 = np.cumsum(ys ** 2)[:-1]
            nl = np.arange(1, n)
            nr = n - nl
            ok = (xs[1:] > xs[:-1]) & (nl >= self.min_leaf) & \
                 (nr >= self.min_leaf)
            if not ok.any():
                continue
            sse = (cl2 - cl ** 2 / nl) + \
                  ((sq - cl2) - (total - cl) ** 2 / nr)
            sse = np.where(ok, sse, np.inf)
            j = int(np.argmin(sse))
            gain = base - sse[j]
            if gain > best[2] + 1e-12:
                best = (int(f), float((xs[j] + xs[j + 1]) / 2), float(gain))
        return best

    def _fill_leaf(self, node: int, depth: int, value: float):
        """Make the whole subtree under (node, depth) return `value`."""
        NN = (1 << self.D) - 1
        if node >= NN:
            self.leaf[node - NN] = value
            return
        self.feat[node] = 0
        self.thr[node] = np.inf  # x[0] >= inf is False -> always left
        # all leaves reachable from here get the value (right side too, for
        # safety against NaNs)
        lo, hi = node, node
        for _ in range(self.D - depth):
            lo = 2 * lo + 1
            hi = 2 * hi + 2
        self.leaf[lo - NN: hi - NN + 1] = value

    def _build(self, idx, node: int, depth: int):
        y = self._y[idx]
        if depth == self.D or len(idx) < 2 * self.min_leaf or \
                np.ptp(y) < 1e-12:
            self._fill_leaf(node, depth, float(y.mean()))
            return
        f, t, gain = self._best_split(idx)
        if f is None:
            self._fill_leaf(node, depth, float(y.mean()))
            return
        self.feat[node] = f
        self.thr[node] = t
        mask = self._X[idx, f] < t
        self._build(idx[mask], 2 * node + 1, depth + 1)
        self._build(idx[~mask], 2 * node + 2, depth + 1)


# ---------------------------------------------------------------------------
# Random forest
# ---------------------------------------------------------------------------


@dataclass
class ForestArrays:
    feat: np.ndarray   # (T, 2^D - 1) int32
    thr: np.ndarray    # (T, 2^D - 1) float32
    leaf: np.ndarray   # (T, 2^D) float32


class RandomForestRegressor:
    def __init__(self, n_trees: int = 32, max_depth: int = 8,
                 min_samples_leaf: int = 2, seed: int = 0, device=None):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.seed = seed
        #: where the torch/cuda engines run (None = the card)
        self.device = device
        self.arrays: Optional[ForestArrays] = None
        self.train_time_s = 0.0
        self._device_arrays = None   # torch copies, uploaded once per fit

    def fit(self, X: np.ndarray, y: np.ndarray):
        t0 = time.perf_counter()
        rng = np.random.default_rng(self.seed)
        feats, thrs, leaves = [], [], []
        n = len(y)
        for _ in range(self.n_trees):
            bidx = rng.integers(0, n, n)
            tree = _CART(self.max_depth, self.min_samples_leaf, rng=rng)
            tree.fit(X[bidx], y[bidx])
            feats.append(tree.feat)
            thrs.append(tree.thr)
            leaves.append(tree.leaf)
        self.arrays = ForestArrays(np.stack(feats), np.stack(thrs),
                                   np.stack(leaves))
        self._device_arrays = None   # stale after a refit
        self.train_time_s = time.perf_counter() - t0
        return self

    def load_arrays(self, feat: np.ndarray, thr: np.ndarray,
                    leaf: np.ndarray):
        """Adopt a forest fitted elsewhere (the complete-tree arrays of
        a ``ForestArrays``) in place of ``fit``; tree count and depth
        follow the arrays."""
        feat = np.ascontiguousarray(feat, np.int32)
        thr = np.ascontiguousarray(thr, np.float32)
        leaf = np.ascontiguousarray(leaf, np.float32)
        t, nn = feat.shape
        depth = (nn + 1).bit_length() - 1
        if (1 << depth) - 1 != nn or thr.shape != feat.shape \
                or leaf.shape != (t, nn + 1):
            raise ValueError(
                f"not a complete-tree forest: feat {feat.shape}, thr "
                f"{thr.shape}, leaf {leaf.shape}")
        self.n_trees, self.max_depth = t, depth
        self.arrays = ForestArrays(feat, thr, leaf)
        self._device_arrays = None
        return self

    # -- inference engines ------------------------------------------------

    def device_arrays(self) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
        """The flattened forest as (feat, thr, leaf) tensors on
        ``self.device``, uploaded once per fit and shared by every
        torch/cuda inference and the fused capacity sweep — repeat
        drains re-read the forest without re-transfer."""
        assert self.arrays is not None, "fit first"
        if self._device_arrays is None:
            a = self.arrays
            self._device_arrays = forest_from_numpy(a.feat, a.thr, a.leaf,
                                                    self.device)
        return self._device_arrays

    def predict(self, X: np.ndarray, engine: str = "numpy") -> np.ndarray:
        assert self.arrays is not None, "fit first"
        X = np.atleast_2d(np.asarray(X, np.float32))
        if engine == "numpy":
            return self._predict_numpy(X)
        if engine not in INFERENCE_ENGINES:
            raise ValueError(f"unknown inference engine {engine!r} "
                             f"(have {INFERENCE_ENGINES})")
        from ..kernels import ops
        feat, thr, leaf = self.device_arrays()
        x = torch.from_numpy(np.ascontiguousarray(X)).to(feat.device)
        out = ops.rfr_op(x, feat, thr, leaf, use_kernel=(engine == "cuda"))
        return out.cpu().numpy()

    def _predict_numpy(self, X: np.ndarray) -> np.ndarray:
        a = self.arrays
        N = X.shape[0]
        T, NN = a.feat.shape
        idx = np.zeros((N, T), np.int64)
        t_ids = np.arange(T)[None, :]
        for _ in range(self.max_depth):
            f = a.feat[t_ids, idx]
            t = a.thr[t_ids, idx]
            go_right = X[np.arange(N)[:, None], f] >= t
            idx = 2 * idx + 1 + go_right
        vals = a.leaf[t_ids, idx - NN]
        return vals.mean(axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# Online predictor with incremental retraining (paper §6)
# ---------------------------------------------------------------------------


class PerfPredictor:
    """Wraps the forest with the paper's operational loop: a growing
    training set, periodic retraining, per-function convergence tracking,
    and inference accounting (count + wall time) for the scheduling-cost
    benchmarks."""

    def __init__(self, n_trees: int = 32, max_depth: int = 8,
                 retrain_every: int = 64, seed: int = 0,
                 engine: str = "cuda", log_target: bool = True,
                 device=None):
        self.model = RandomForestRegressor(n_trees, max_depth, seed=seed,
                                           device=device)
        self.engine = engine
        # Queueing-shaped latency labels are heavy-tailed; regressing
        # log-latency makes leaf averages multiplicative and roughly
        # halves the relative error near the QoS boundary.
        self.log_target = log_target
        self.retrain_every = retrain_every
        self._X: List[np.ndarray] = []
        self._y: List[float] = []
        self._since_retrain = 0
        self.inference_count = 0
        self.inference_calls = 0
        self.inference_time_s = 0.0
        self.retrain_count = 0
        self.fitted = False

    @property
    def engine(self) -> str:
        return self._engine

    @engine.setter
    def engine(self, name: str):
        """Select the inference engine.  A device engine checks its
        device now; on the card it also starts the CUDA context and, for
        ``"cuda"``, builds and loads the kernels now, so none of that
        lands inside the timed inference whose mean feeds scheduling
        (``JiaguScheduler._queue_update``)."""
        if name not in INFERENCE_ENGINES:
            raise ValueError(f"unknown inference engine {name!r} "
                             f"(have {INFERENCE_ENGINES})")
        if name != "numpy":
            dev = resolve_device(self.model.device)
            if dev.type == "cuda":
                torch.zeros(1, device=dev)
                if name == "cuda":
                    from ..kernels import _build
                    _build.load("rfr_inference")
        self._engine = name

    @property
    def n_samples(self) -> int:
        return len(self._y)

    def dataset(self) -> Tuple[np.ndarray, np.ndarray]:
        """The accumulated training set as (X, y) arrays (empty arrays
        before any sample) — validation consumers (the service's
        learned shape margins) read it without touching internals."""
        if not self._y:
            return (np.empty((0, 0), np.float32),
                    np.empty(0, np.float64))
        return np.stack(self._X), np.asarray(self._y, np.float64)

    def add_sample(self, x: np.ndarray, y: float, retrain: bool = True):
        self._X.append(np.asarray(x, np.float32))
        self._y.append(float(y))
        self._since_retrain += 1
        if retrain and (not self.fitted
                        or self._since_retrain >= self.retrain_every):
            self.retrain()

    def add_dataset(self, X: np.ndarray, y: np.ndarray,
                    retrain: bool = True):
        for xi, yi in zip(X, y):
            self._X.append(np.asarray(xi, np.float32))
            self._y.append(float(yi))
        if retrain:
            self.retrain()

    def retrain(self):
        if not self._y:
            return
        y = np.asarray(self._y)
        if self.log_target:
            y = np.log(np.maximum(y, 1e-6))
        self.model.fit(np.stack(self._X), y)
        self._since_retrain = 0
        self.retrain_count += 1
        self.fitted = True

    def predict(self, X: np.ndarray) -> np.ndarray:
        """One *batched* inference ("once" cost in the paper's terms)."""
        X = np.atleast_2d(X)
        t0 = time.perf_counter()
        out = self.model.predict(X, engine=self.engine)
        if self.log_target:
            out = np.exp(out)
        self.inference_time_s += time.perf_counter() - t0
        self.inference_calls += 1
        self.inference_count += len(X)
        return out

    def record_inference(self, rows: int, seconds: float) -> None:
        """Bill inference performed outside ``predict`` — the
        device-resident capacity sweep scores rows in its own fused
        kernel — into the same accounting the scheduling-cost
        benchmarks read."""
        self.inference_calls += 1
        self.inference_count += int(rows)
        self.inference_time_s += seconds

    def predict_many(self, Xs: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Score several feature matrices in ONE batched inference call
        (the multi-query API behind the cluster-scale capacity engine:
        every unresolved scenario of a drain rides the same forest pass).
        Returns per-matrix prediction arrays."""
        mats = [np.atleast_2d(x) for x in Xs]
        if not mats:
            return []
        out = self.predict(np.concatenate(mats, axis=0))
        splits = np.cumsum([len(m) for m in mats])[:-1]
        return np.split(out, splits)

    @property
    def mean_inference_ms(self) -> float:
        return 1e3 * self.inference_time_s / max(self.inference_calls, 1)


# ---------------------------------------------------------------------------
# Fig-16 comparison zoo (from-scratch baselines)
# ---------------------------------------------------------------------------


class LinearModel:
    def __init__(self, l2: float = 0.0, quadratic: bool = False):
        self.l2 = l2
        self.quadratic = quadratic
        self.w = None
        self.train_time_s = 0.0

    def _phi(self, X):
        X = np.atleast_2d(X)
        if self.quadratic:  # ESP-style quadratic expansion (diagonal)
            X = np.concatenate([X, X ** 2], axis=1)
        return np.concatenate([X, np.ones((len(X), 1))], axis=1)

    def fit(self, X, y):
        t0 = time.perf_counter()
        P = self._phi(X)
        A = P.T @ P + self.l2 * np.eye(P.shape[1])
        self.w = np.linalg.solve(A, P.T @ y)
        self.train_time_s = time.perf_counter() - t0
        return self

    def predict(self, X, engine=None):
        return self._phi(X) @ self.w


class GradientBoostedTrees:
    """XGBoost-style: sequential depth-limited CARTs on residuals."""

    def __init__(self, n_rounds: int = 40, max_depth: int = 4,
                 lr: float = 0.15, seed: int = 0):
        self.n_rounds, self.max_depth, self.lr = n_rounds, max_depth, lr
        self.seed = seed
        self.trees: List[_CART] = []
        self.base = 0.0
        self.train_time_s = 0.0

    def fit(self, X, y):
        t0 = time.perf_counter()
        rng = np.random.default_rng(self.seed)
        self.base = float(np.mean(y))
        resid = y - self.base
        self.trees = []
        for _ in range(self.n_rounds):
            tr = _CART(self.max_depth, min_samples_leaf=3,
                       max_features=X.shape[1], rng=rng)
            tr.fit(X, resid)
            pred = _tree_predict(tr, X)
            resid = resid - self.lr * pred
            self.trees.append(tr)
        self.train_time_s = time.perf_counter() - t0
        return self

    def predict(self, X, engine=None):
        X = np.atleast_2d(X)
        out = np.full(len(X), self.base, np.float64)
        for tr in self.trees:
            out += self.lr * _tree_predict(tr, X)
        return out.astype(np.float32)


def _tree_predict(tree: _CART, X: np.ndarray) -> np.ndarray:
    N = len(X)
    NN = (1 << tree.D) - 1
    idx = np.zeros(N, np.int64)
    rows = np.arange(N)
    for _ in range(tree.D):
        f = tree.feat[idx]
        t = tree.thr[idx]
        idx = 2 * idx + 1 + (X[rows, f] >= t)
    return tree.leaf[idx - NN]


class MLPRegressor:
    """Small fully-connected net, numpy Adam, for the Fig-16 comparison."""

    def __init__(self, n_layers: int = 2, width: int = 64,
                 epochs: int = 300, lr: float = 1e-3, seed: int = 0):
        self.n_layers, self.width = n_layers, width
        self.epochs, self.lr, self.seed = epochs, lr, seed
        self.params = None
        self.train_time_s = 0.0
        self._norm = None

    def _init(self, F):
        rng = np.random.default_rng(self.seed)
        dims = [F] + [self.width] * (self.n_layers - 1) + [1]
        return [(rng.normal(0, np.sqrt(2.0 / d_in), (d_in, d_out)),
                 np.zeros(d_out))
                for d_in, d_out in zip(dims[:-1], dims[1:])]

    def _fwd(self, X, params):
        acts = [X]
        h = X
        for i, (W, b) in enumerate(params):
            h = h @ W + b
            if i < len(params) - 1:
                h = np.maximum(h, 0)
            acts.append(h)
        return h[:, 0], acts

    def fit(self, X, y):
        t0 = time.perf_counter()
        X = np.asarray(X, np.float64)
        mu, sd = X.mean(0), X.std(0) + 1e-8
        ymu, ysd = float(np.mean(y)), float(np.std(y) + 1e-8)
        self._norm = (mu, sd, ymu, ysd)
        Xn = (X - mu) / sd
        yn = (np.asarray(y, np.float64) - ymu) / ysd
        params = self._init(X.shape[1])
        m = [(np.zeros_like(W), np.zeros_like(b)) for W, b in params]
        v = [(np.zeros_like(W), np.zeros_like(b)) for W, b in params]
        b1, b2, eps = 0.9, 0.999, 1e-8
        step = 0
        for _ in range(self.epochs):
            pred, acts = self._fwd(Xn, params)
            err = (pred - yn)[:, None] / len(yn) * 2
            grads = []
            delta = err
            for i in reversed(range(len(params))):
                W, b = params[i]
                a_in = acts[i]
                gW = a_in.T @ delta
                gb = delta.sum(0)
                grads.append((gW, gb))
                if i > 0:
                    delta = (delta @ W.T) * (acts[i] > 0)
            grads.reverse()
            step += 1
            new_params = []
            for i, ((W, b), (gW, gb)) in enumerate(zip(params, grads)):
                mW, mb = m[i]
                vW, vb = v[i]
                mW = b1 * mW + (1 - b1) * gW
                mb = b1 * mb + (1 - b1) * gb
                vW = b2 * vW + (1 - b2) * gW ** 2
                vb = b2 * vb + (1 - b2) * gb ** 2
                m[i], v[i] = (mW, mb), (vW, vb)
                mhW = mW / (1 - b1 ** step)
                mhb = mb / (1 - b1 ** step)
                vhW = vW / (1 - b2 ** step)
                vhb = vb / (1 - b2 ** step)
                new_params.append((W - self.lr * mhW / (np.sqrt(vhW) + eps),
                                   b - self.lr * mhb / (np.sqrt(vhb) + eps)))
            params = new_params
        self.params = params
        self.train_time_s = time.perf_counter() - t0
        return self

    def predict(self, X, engine=None):
        mu, sd, ymu, ysd = self._norm
        Xn = (np.atleast_2d(np.asarray(X, np.float64)) - mu) / sd
        pred, _ = self._fwd(Xn, self.params)
        return (pred * ysd + ymu).astype(np.float32)


MODEL_ZOO = {
    "RFR (Jiagu)": lambda: RandomForestRegressor(32, 8),
    "Linear": lambda: LinearModel(0.0),
    "Ridge": lambda: LinearModel(1.0),
    "ESP (quad. ridge)": lambda: LinearModel(1.0, quadratic=True),
    "XGBoost-style GBT": lambda: GradientBoostedTrees(),
    "MLP-2": lambda: MLPRegressor(2),
    "MLP-3": lambda: MLPRegressor(3),
    "MLP-4": lambda: MLPRegressor(4),
}
