"""Interpretable models, reimplemented in numpy (sklearn/imodels are not
available offline): linear / ridge regression and CART / random-forest
regressors with multi-output targets.

The paper's best model is a random forest with <= 10 trees and depth <= 5 —
small enough that an exact-split CART is instant and the learned rules can
be printed (``DecisionTree.rules()``).

The port's copy of ``repro.core.forest``, verbatim.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


class LinearRegression:
    def __init__(self, l2: float = 0.0):
        self.l2 = l2
        self.coef: Optional[np.ndarray] = None

    def fit(self, x: np.ndarray, y: np.ndarray) -> "LinearRegression":
        x = np.asarray(x, float)
        y = np.asarray(y, float)
        xb = np.concatenate([x, np.ones((len(x), 1))], axis=1)
        if self.l2:
            a = xb.T @ xb + self.l2 * np.eye(xb.shape[1])
            self.coef = np.linalg.solve(a, xb.T @ y)
        else:
            self.coef, *_ = np.linalg.lstsq(xb, y, rcond=None)
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        xb = np.concatenate([np.asarray(x, float),
                             np.ones((len(x), 1))], axis=1)
        return xb @ self.coef


def Ridge(l2: float = 1.0) -> LinearRegression:
    return LinearRegression(l2=l2)


@dataclasses.dataclass
class _Node:
    feature: int = -1
    threshold: float = 0.0
    left: int = -1
    right: int = -1
    value: Optional[np.ndarray] = None   # leaf mean (targets,)

    @property
    def is_leaf(self) -> bool:
        return self.feature < 0


class DecisionTree:
    """Exact-split CART regressor (variance reduction, multi-output)."""

    def __init__(self, max_depth: int = 5, min_samples_leaf: int = 3,
                 max_features: Optional[int] = None, seed: int = 0):
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.max_features = max_features
        self.rng = np.random.default_rng(seed)
        self.nodes: List[_Node] = []

    def _best_split(self, x, y):
        n, f = x.shape
        feats = np.arange(f)
        if self.max_features and self.max_features < f:
            feats = self.rng.choice(f, self.max_features, replace=False)
        best = (None, None, np.inf)
        for j in feats:
            order = np.argsort(x[:, j], kind="stable")
            xs, ys = x[order, j], y[order]
            csum = np.cumsum(ys, axis=0)
            csum2 = np.cumsum(ys ** 2, axis=0)
            tot, tot2 = csum[-1], csum2[-1]
            ks = np.arange(1, n)
            valid = xs[1:] > xs[:-1]
            ks = ks[valid & (ks >= self.min_samples_leaf)
                    & (ks <= n - self.min_samples_leaf)]
            if len(ks) == 0:
                continue
            left2 = csum2[ks - 1] - csum[ks - 1] ** 2 / ks[:, None]
            nr = n - ks
            right2 = (tot2 - csum2[ks - 1]) - \
                (tot - csum[ks - 1]) ** 2 / nr[:, None]
            sse = left2.sum(axis=1) + right2.sum(axis=1)
            i = int(np.argmin(sse))
            if sse[i] < best[2]:
                k = ks[i]
                thr = 0.5 * (xs[k - 1] + xs[k])
                best = (int(j), float(thr), float(sse[i]))
        return best

    def _build(self, x, y, depth) -> int:
        node_id = len(self.nodes)
        self.nodes.append(_Node(value=y.mean(axis=0)))
        if depth >= self.max_depth or len(x) < 2 * self.min_samples_leaf \
                or np.allclose(y.var(axis=0).sum(), 0.0):
            return node_id
        j, thr, sse = self._best_split(x, y)
        if j is None:
            return node_id
        mask = x[:, j] <= thr
        base_sse = ((y - y.mean(axis=0)) ** 2).sum()
        if base_sse - sse < 1e-12:
            return node_id
        self._importance[j] += base_sse - sse
        node = self.nodes[node_id]
        node.feature, node.threshold = j, thr
        node.left = self._build(x[mask], y[mask], depth + 1)
        node.right = self._build(x[~mask], y[~mask], depth + 1)
        return node_id

    def fit(self, x, y) -> "DecisionTree":
        x = np.asarray(x, float)
        y = np.asarray(y, float)
        if y.ndim == 1:
            y = y[:, None]
        self.nodes = []
        self._importance = np.zeros(x.shape[1])
        self._build(x, y, 0)
        return self

    def feature_importances(self) -> np.ndarray:
        """Impurity-decrease importances, normalised to sum to 1 (the
        paper's interpretability, quantified)."""
        tot = self._importance.sum()
        if tot <= 0:
            return np.zeros_like(self._importance)
        return self._importance / tot

    def predict(self, x) -> np.ndarray:
        x = np.asarray(x, float)
        out = np.zeros((len(x), len(self.nodes[0].value)))
        for i, row in enumerate(x):
            nid = 0
            while not self.nodes[nid].is_leaf:
                nd = self.nodes[nid]
                nid = nd.left if row[nd.feature] <= nd.threshold else nd.right
            out[i] = self.nodes[nid].value
        return out

    def rules(self, feature_names: Optional[Sequence[str]] = None,
              target_names: Optional[Sequence[str]] = None) -> List[str]:
        """Human-readable decision rules (the paper's interpretability)."""
        names = feature_names or [f"x{i}" for i in range(100)]
        lines: List[str] = []

        def walk(nid, path):
            nd = self.nodes[nid]
            if nd.is_leaf:
                tgt = ", ".join(
                    f"{(target_names or ['y'] * len(nd.value))[i]}="
                    f"{v:.3g}" for i, v in enumerate(nd.value))
                lines.append(("IF " + " AND ".join(path) if path
                              else "ALWAYS") + f" THEN {tgt}")
                return
            walk(nd.left, path + [f"{names[nd.feature]} <= {nd.threshold:.3g}"])
            walk(nd.right, path + [f"{names[nd.feature]} > {nd.threshold:.3g}"])

        walk(0, [])
        return lines


class RandomForest:
    """Bagged CART ensemble (default: paper's 10 trees, depth 5)."""

    def __init__(self, n_trees: int = 10, max_depth: int = 5,
                 min_samples_leaf: int = 3,
                 max_features: Optional[str] = None, seed: int = 0):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.max_features = max_features
        self.seed = seed
        self.trees: List[DecisionTree] = []

    def fit(self, x, y) -> "RandomForest":
        x = np.asarray(x, float)
        y = np.asarray(y, float)
        if y.ndim == 1:
            y = y[:, None]
        rng = np.random.default_rng(self.seed)
        n, f = x.shape
        mf = None
        if self.max_features == "sqrt":
            mf = max(int(np.sqrt(f)), 1)
        self.trees = []
        for t in range(self.n_trees):
            idx = rng.integers(0, n, n)          # bootstrap
            tree = DecisionTree(self.max_depth, self.min_samples_leaf,
                                max_features=mf, seed=self.seed + t + 1)
            tree.fit(x[idx], y[idx])
            self.trees.append(tree)
        return self

    def predict(self, x) -> np.ndarray:
        preds = [t.predict(x) for t in self.trees]
        return np.mean(preds, axis=0)

    def feature_importances(self) -> np.ndarray:
        """Mean of the trees' normalised impurity-decrease importances,
        renormalised (stump trees contribute zeros)."""
        if not self.trees:
            raise RuntimeError("fit before feature_importances")
        imp = np.mean([t.feature_importances() for t in self.trees],
                      axis=0)
        tot = imp.sum()
        return imp / tot if tot > 0 else imp


MODEL_ZOO = {
    "linear": lambda: LinearRegression(),
    "ridge": lambda: Ridge(1.0),
    "tree": lambda: DecisionTree(max_depth=5),
    "forest": lambda: RandomForest(n_trees=10, max_depth=5),
}
