"""Search algorithms: the ask/tell ``Searcher`` plugin API, the default
variant generator behind it, and a model-based TPE searcher (port of
``ray_tpu/tune/search.py``: ``TPESearcher`` :204, ``BOHBSearcher`` :513).

numpy only, as the reference: the same seed and history give the same
suggestions, draw for draw (``tests/test_torch_tune.py``).

Reference parity: ``python/ray/tune/search/searcher.py:21`` (Searcher:
``suggest`` / ``on_trial_result`` / ``on_trial_complete`` /
``set_search_properties``), ``search/basic_variant.py`` (grid x random),
and the model-based integrations (``search/optuna``, ``search/hyperopt``,
...). Rather than wrapping external libraries, the model-based searcher is
implemented here directly: a Tree-structured Parzen Estimator — the
algorithm behind hyperopt and optuna's default sampler — over the native
search-space ``Domain`` types.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ray_tpu_torch.tune.search_space import (
    Choice,
    Domain,
    LogUniform,
    QUniform,
    RandInt,
    Uniform,
    _is_grid,
    generate_variants,
)


class Searcher:
    """Ask/tell interface. Subclasses implement ``suggest`` and (usually)
    ``on_trial_complete``; the TrialRunner drives:

        cfg = searcher.suggest(trial_id)      # None = wait / exhausted
        ...trial runs...
        searcher.on_trial_result(trial_id, result)      # each report
        searcher.on_trial_complete(trial_id, result)    # final
    """

    #: True for searchers that pre-expand their own trial budget (grid x
    #: num_samples). The runner must then run them to exhaustion instead of
    #: capping at ``num_samples`` — a grid of 3 with num_samples=2 is 6
    #: trials, not 2.
    expands_variants = False

    def __init__(self, metric: Optional[str] = None, mode: str = "max"):
        if mode not in ("max", "min"):
            raise ValueError("mode must be 'max' or 'min'")
        self.metric = metric
        self.mode = mode

    def set_search_properties(self, metric: Optional[str], mode: Optional[str],
                              config: Dict[str, Any]) -> bool:
        """Late-bind metric/mode/space from the Tuner. Returns False if the
        searcher was already configured with a conflicting space."""
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode
        return True

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        pass

    def on_trial_complete(self, trial_id: str, result: Optional[dict] = None,
                          error: bool = False) -> None:
        pass

    def tell(self, config: Dict[str, Any],
             result: Optional[dict]) -> None:
        """Inject an out-of-band observation (experiment restore replays
        finished trials this way — their ids were never suggest()-ed)."""
        pass

    # -- shared helpers ----------------------------------------------------

    def _score(self, result: Optional[dict]) -> Optional[float]:
        if not result or self.metric is None:
            return None
        v = result.get(self.metric)
        if v is None:
            return None
        return -float(v) if self.mode == "min" else float(v)


class BasicVariantSearcher(Searcher):
    """The default searcher: pre-expands grid x num_samples variants and
    deals them out (``search/basic_variant.py`` semantics)."""

    expands_variants = True

    def __init__(self, param_space: Dict[str, Any], num_samples: int = 1,
                 seed: Optional[int] = None, **kw):
        super().__init__(**kw)
        self._variants = generate_variants(
            param_space, num_samples=num_samples, seed=seed)
        self._next = 0

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._next >= len(self._variants):
            return None
        cfg = self._variants[self._next]
        self._next += 1
        return cfg


# ---------------------------------------------------------------------------
# TPE
# ---------------------------------------------------------------------------


def _flatten(space: dict, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in space.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict) and not _is_grid(v):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split(".")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


class _NumDim:
    """A numeric dimension in the (possibly log-) transformed unit space."""

    def __init__(self, domain):
        self.domain = domain
        self.log = isinstance(domain, LogUniform)
        if isinstance(domain, (Uniform, LogUniform)):
            lo, hi = domain.low, domain.high
        elif isinstance(domain, QUniform):
            lo, hi = domain.low, domain.high
        elif isinstance(domain, RandInt):
            lo, hi = domain.low, domain.high - 1
        else:
            raise TypeError(domain)
        self.lo = np.log(lo) if self.log else float(lo)
        self.hi = np.log(hi) if self.log else float(hi)
        self.width = max(self.hi - self.lo, 1e-12)

    def to_unit(self, v: float) -> float:
        x = np.log(v) if self.log else float(v)
        return float(np.clip((x - self.lo) / self.width, 0.0, 1.0))

    def from_unit(self, u: float):
        x = self.lo + float(np.clip(u, 0.0, 1.0)) * self.width
        v = float(np.exp(x)) if self.log else float(x)
        d = self.domain
        if isinstance(d, QUniform):
            v = float(np.round(v / d.q) * d.q)
        elif isinstance(d, RandInt):
            v = int(np.clip(round(v), d.low, d.high - 1))
        return v


def _parzen_logpdf(x: np.ndarray, centers: np.ndarray,
                   bws: np.ndarray) -> np.ndarray:
    """log density of a gaussian-mixture KDE (per-component bandwidths)
    blended with a uniform prior over [0,1] (weight 1/(n+1), shrinking as
    data accumulates). The prior keeps the l/g ratio well-conditioned in
    unexplored regions — without it TPE ping-pongs between empty corners
    where both densities underflow."""
    if centers.size == 0:
        return np.zeros_like(x)  # uniform prior only
    d = (x[:, None] - centers[None, :]) / bws[None, :]
    log_k = -0.5 * d * d - np.log(bws[None, :] * np.sqrt(2 * np.pi))
    m = log_k.max(axis=1, keepdims=True)
    kde = m[:, 0] + np.log(np.mean(np.exp(log_k - m), axis=1))
    prior_w = 1.0 / (centers.size + 1.0)
    return np.logaddexp(np.log(prior_w), np.log1p(-prior_w) + kde)


def _adaptive_bw(centers: np.ndarray, bw_min: float = 0.03) -> np.ndarray:
    """Per-point bandwidth = the larger neighbor gap after sorting (domain
    ends [0,1] count as neighbors) — hyperopt's heuristic: dense clusters
    get sharp kernels, isolated points stay wide."""
    if centers.size == 0:
        return centers
    order = np.argsort(centers)
    s = centers[order]
    ext = np.concatenate([[0.0], s, [1.0]])
    gaps = np.maximum(ext[1:-1] - ext[:-2], ext[2:] - ext[1:-1])
    out = np.empty_like(gaps)
    out[order] = np.clip(gaps, bw_min, 1.0)
    return out


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator (Bergstra et al. 2011 — the model
    behind hyperopt; cf. the reference's ``search/hyperopt`` integration).

    After ``n_initial`` random suggestions, observations split into a
    "good" top-``gamma`` quantile and the rest; each dimension gets 1-D
    Parzen density estimates l(x) (good) and g(x) (bad), and the next
    suggestion maximizes l/g over ``n_candidates`` draws from l.

    ``multivariate`` (optuna's ``TPESampler(multivariate=True)`` analog,
    default ``"auto"``): model the good/bad sets with JOINT per-
    observation product kernels over the whole unit hypercube instead of
    independent per-dimension estimates. Candidates are drawn as whole
    vectors around good observations, so correlations between dimensions
    (e.g. lr x batch-size ridges) survive into the suggestions — the
    canonical independent model mixes marginals and loses them. "auto"
    uses the joint model when every dimension is numeric/categorical and
    both split sides have >= 2 observations, falling back to the
    univariate model otherwise.
    """

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 param_space: Optional[Dict[str, Any]] = None,
                 n_initial: int = 8, gamma: float = 0.25,
                 n_candidates: int = 32, seed: Optional[int] = None,
                 multivariate: "bool | str" = "auto"):
        super().__init__(metric=metric, mode=mode)
        self.multivariate = multivariate
        self._space: Dict[str, Any] = {}
        if param_space:
            self._set_space(param_space)
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.rng = np.random.default_rng(seed)
        self._live: Dict[str, Dict[str, Any]] = {}   # trial_id -> flat cfg
        self._obs: list[tuple[Dict[str, Any], float]] = []

    def _set_space(self, space: Dict[str, Any]) -> None:
        flat = _flatten(space)
        self._space = {}
        for k, v in flat.items():
            if _is_grid(v):
                v = Choice(v["grid_search"])  # grids become categoricals
            self._space[k] = v

    def set_search_properties(self, metric, mode, config) -> bool:
        if self._space and config:
            return False  # space fixed at construction
        super().set_search_properties(metric, mode, config)
        if config:
            self._set_space(config)
        return True

    # -- ask ---------------------------------------------------------------

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if not self._space:
            raise ValueError("TPESearcher has no search space")
        if len(self._obs) < self.n_initial:
            flat = self._random_flat()
        else:
            flat = self._model_flat()
        self._live[trial_id] = flat
        return _unflatten(flat)

    def _random_flat(self) -> Dict[str, Any]:
        out = {}
        for k, v in self._space.items():
            out[k] = v.sample(self.rng) if isinstance(v, Domain) else v
        return out

    def _model_flat(self) -> Dict[str, Any]:
        scores = np.array([s for _, s in self._obs])
        # hyperopt's split: the good set is the top ceil(gamma * sqrt(n)),
        # capped — a handful of elite points keeps l(x) sharp. A
        # proportional split (gamma * n) flattens l over mediocre points
        # and measures no better than random on the test surfaces.
        n_good = max(2, min(25, int(np.ceil(
            self.gamma * np.sqrt(len(scores))))))
        order = np.argsort(-scores)  # maximize internally
        good_idx = set(order[:n_good].tolist())
        if self.multivariate in (True, "auto"):
            # The joint KDE needs a denser good set than the univariate
            # elite-only split: per-observation product kernels around 2
            # points don't carve out a manifold. Proportional split
            # (optuna's gamma): ~15% of observations, at least 4.
            n_good_j = max(4, min(25, int(np.ceil(0.15 * len(scores)))))
            out = self._joint_suggest(set(order[:n_good_j].tolist()))
            if out is not None:
                return out
        out = {}
        for k, dom in self._space.items():
            if not isinstance(dom, Domain):
                out[k] = dom
                continue
            good = [cfg[k] for i, (cfg, _) in enumerate(self._obs)
                    if i in good_idx and k in cfg]
            bad = [cfg[k] for i, (cfg, _) in enumerate(self._obs)
                   if i not in good_idx and k in cfg]
            if isinstance(dom, Choice):
                out[k] = self._suggest_categorical(dom, good, bad)
            elif isinstance(dom, (Uniform, LogUniform, QUniform, RandInt)):
                out[k] = self._suggest_numeric(dom, good, bad)
            else:
                # Unmodellable domain (e.g. SampleFrom): keep sampling
                # from it rather than crash the search mid-experiment.
                out[k] = dom.sample(self.rng)
        return out

    # -- joint (multivariate) model ---------------------------------------

    def _joint_suggest(self, good_idx) -> Optional[Dict[str, Any]]:
        """Joint-kernel TPE over the whole space: l(x) and g(x) are
        mixtures of per-OBSERVATION product kernels (gaussian on numeric
        dims in unit space, Aitchison–Aitken-style on categoricals), and
        candidates are whole vectors drawn around good observations.
        Returns None when the space/observations don't support the joint
        model (caller falls back to the univariate path)."""
        numd: list = []   # (key, _NumDim)
        catd: list = []   # (key, Choice, {cat_key: idx})
        fixed: Dict[str, Any] = {}
        for k, dom in self._space.items():
            if not isinstance(dom, Domain):
                fixed[k] = dom
            elif isinstance(dom, Choice):
                catd.append((k, dom, {self._cat_key(c): i
                                      for i, c in enumerate(dom.categories)}))
            elif isinstance(dom, (Uniform, LogUniform, QUniform, RandInt)):
                numd.append((k, _NumDim(dom)))
            else:
                return None  # SampleFrom etc.: not jointly modellable
        if not numd and not catd:
            return None

        def rows(idx_filter):
            num, cat = [], []
            for i, (cfg, _) in enumerate(self._obs):
                if not idx_filter(i):
                    continue
                try:
                    num.append([nd.to_unit(cfg[k]) for k, nd in numd])
                    cat.append([lut[self._cat_key(cfg[k])]
                                for k, _dom, lut in catd])
                except (KeyError, TypeError):
                    continue  # stale/partial observation: skip
            return (np.array(num, dtype=float).reshape(len(num), len(numd)),
                    np.array(cat, dtype=int).reshape(len(cat), len(catd)))

        g_num, g_cat = rows(lambda i: i in good_idx)
        b_num, b_cat = rows(lambda i: i not in good_idx)
        if len(g_num) < 2 or len(b_num) < 2:
            return None

        # Per-point per-dim bandwidths from the neighbor-gap heuristic.
        def bws(mat):
            out = np.empty_like(mat)
            for d in range(mat.shape[1]):
                out[:, d] = _adaptive_bw(mat[:, d])
            return out

        bw_g, bw_b = bws(g_num), bws(b_num)
        ncat = np.array([len(dom.categories) for _k, dom, _l in catd],
                        dtype=float)
        w_same = 0.8  # categorical kernel mass on the observed category

        n = max(self.n_candidates, 4 * (len(numd) + len(catd)))
        rng = self.rng
        w_prior = 1.0 / (len(g_num) + 1.0)
        from_prior = rng.uniform(size=n) < w_prior
        pick = rng.integers(0, len(g_num), n)
        # Numeric dims: gaussian around the picked good ROW (whole-vector
        # draws keep cross-dim structure), reflected at the bounds.
        if numd:
            centers = np.where(from_prior[:, None],
                               rng.uniform(0, 1, (n, len(numd))),
                               g_num[pick])
            widths = np.where(from_prior[:, None], 0.25, bw_g[pick])
            cand = centers + rng.normal(0, 1, (n, len(numd))) * widths
            cand = np.abs(cand)
            cand = 1.0 - np.abs(1.0 - cand)
            cand = np.clip(cand, 0.0, 1.0)
        else:
            cand = np.zeros((n, 0))
        if catd:
            keep = rng.uniform(size=(n, len(catd))) < w_same
            rand_cat = np.stack(
                [rng.integers(0, len(dom.categories), n)
                 for _k, dom, _l in catd], axis=1)
            cand_cat = np.where(from_prior[:, None] | ~keep,
                                rand_cat, g_cat[pick])
        else:
            cand_cat = np.zeros((n, 0), dtype=int)

        def log_density(num_mat, cat_mat, bw):
            """log mixture density of each candidate under the set's
            per-observation product kernels (+ uniform prior mixture)."""
            if len(num_mat) == 0:
                return np.zeros(n)
            # [n_cand, n_obs, D] broadcasting; n and n_obs are both small
            # (tens), so the dense intermediate is fine.
            if numd:
                d = (cand[:, None, :] - num_mat[None, :, :]) / bw[None, :, :]
                log_k = (-0.5 * d * d
                         - np.log(bw[None, :, :] * np.sqrt(2 * np.pi))
                         ).sum(axis=2)
            else:
                log_k = np.zeros((n, len(num_mat)))
            if catd:
                same = cand_cat[:, None, :] == cat_mat[None, :, :]
                log_k = log_k + np.where(
                    same, np.log(w_same),
                    np.log((1 - w_same) / np.maximum(ncat - 1, 1.0))
                ).sum(axis=2)
            m = log_k.max(axis=1, keepdims=True)
            kde = m[:, 0] + np.log(
                np.mean(np.exp(log_k - m), axis=1))
            # Uniform prior over the hypercube: density 1 on numeric
            # dims, 1/K per categorical dim.
            log_uniform = -np.log(ncat).sum() if catd else 0.0
            pw = 1.0 / (len(num_mat) + 1.0)
            return np.logaddexp(np.log(pw) + log_uniform,
                                np.log1p(-pw) + kde)

        score = (log_density(g_num, g_cat, bw_g)
                 - log_density(b_num, b_cat, bw_b))
        best = int(np.argmax(score))
        out = dict(fixed)
        for j, (k, nd) in enumerate(numd):
            out[k] = nd.from_unit(float(cand[best, j]))
        for j, (k, dom, _lut) in enumerate(catd):
            out[k] = dom.categories[int(cand_cat[best, j])]
        return out

    def _suggest_numeric(self, dom, good, bad):
        nd = _NumDim(dom)
        gu = np.array([nd.to_unit(v) for v in good])
        bu = np.array([nd.to_unit(v) for v in bad])
        bw_g = _adaptive_bw(gu)
        bw_b = _adaptive_bw(bu)
        # Candidates drawn from l(x) itself — a gaussian around a random
        # good point, or (with the prior's weight) a uniform draw, which
        # is ALL the exploration TPE needs once the prior is a genuine
        # mixture component. Reflect at the bounds instead of clipping: a
        # clip piles an atom of candidates ON the boundary, whose KDE
        # spike then self-selects forever (boundary lock-in).
        n = self.n_candidates
        w_prior = 1.0 / (len(gu) + 1.0)
        from_prior = self.rng.uniform(size=n) < w_prior
        if len(gu):
            pick = self.rng.integers(0, len(gu), n)
            centers = np.where(from_prior, self.rng.uniform(0, 1, n),
                               gu[pick])
            widths = np.where(from_prior, 0.25, bw_g[pick])
        else:
            centers = self.rng.uniform(0, 1, n)
            widths = np.full(n, 0.25)
        cand = centers + self.rng.normal(0, 1, n) * widths
        cand = np.abs(cand)
        cand = 1.0 - np.abs(1.0 - cand)
        cand = np.clip(cand, 0.0, 1.0)
        score = _parzen_logpdf(cand, gu, bw_g) - _parzen_logpdf(cand, bu, bw_b)
        return nd.from_unit(float(cand[int(np.argmax(score))]))

    def _suggest_categorical(self, dom: Choice, good, bad):
        cats = dom.categories
        idx = {self._cat_key(c): i for i, c in enumerate(cats)}
        g = np.ones(len(cats))
        b = np.ones(len(cats))
        for v in good:
            i = idx.get(self._cat_key(v))
            if i is not None:
                g[i] += 1
        for v in bad:
            i = idx.get(self._cat_key(v))
            if i is not None:
                b[i] += 1
        ratio = (g / g.sum()) / (b / b.sum())
        probs = ratio / ratio.sum()
        return cats[int(self.rng.choice(len(cats), p=probs))]

    @staticmethod
    def _cat_key(v):
        try:
            return hash(v)
        except TypeError:
            return repr(v)

    # -- tell --------------------------------------------------------------

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        pass  # TPE learns from final results only

    def on_trial_complete(self, trial_id: str, result: Optional[dict] = None,
                          error: bool = False) -> None:
        flat = self._live.pop(trial_id, None)
        if flat is None or error:
            return
        score = self._score(result)
        if score is not None and np.isfinite(score):
            self._obs.append((flat, score))

    def tell(self, config: Dict[str, Any],
             result: Optional[dict]) -> None:
        score = self._score(result)
        if score is not None and np.isfinite(score):
            self._obs.append((_flatten(config), score))


class BOHBSearcher(TPESearcher):
    """BOHB's model-based half (Falkner et al. 2018; the reference wires
    it as ``search/bohb/TuneBOHB`` + ``HyperBandForBOHB``): TPE
    suggestions fit on observations grouped by BUDGET (training
    iteration at which the score was reported), always modeling the
    LARGEST budget that has enough observations — early-rung data guides
    the search until enough high-budget results exist, then the model
    upgrades to the fidelity that matters. Pair it with
    ``HyperBandScheduler`` (the successive-halving rungs produce exactly
    the multi-fidelity observations this models).

    Unlike plain TPE (final results only), intermediate results feed the
    model: every ``on_trial_result`` records (config, score) at that
    budget, keeping the freshest score per trial per budget.
    """

    def __init__(self, *args, min_points_in_model: int = 8, **kwargs):
        super().__init__(*args, **kwargs)
        self.min_points_in_model = min_points_in_model
        # budget -> {trial_id: (flat_cfg, score)}
        self._by_budget: Dict[int, Dict[str, tuple]] = {}

    def _record(self, trial_id: str, result: dict) -> None:
        flat = self._live.get(trial_id)
        score = self._score(result)
        if flat is None or score is None or not np.isfinite(score):
            return
        budget = int(result.get("training_iteration", 1))
        self._by_budget.setdefault(budget, {})[trial_id] = (flat, score)

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        self._record(trial_id, result)

    def on_trial_complete(self, trial_id: str, result: Optional[dict] = None,
                          error: bool = False) -> None:
        if result is not None and not error:
            self._record(trial_id, result)
        self._live.pop(trial_id, None)

    def _refresh_obs(self) -> None:
        """Point self._obs at the largest budget with enough points
        (falling back to pooling everything when no budget qualifies)."""
        best_budget = None
        for budget in sorted(self._by_budget, reverse=True):
            if len(self._by_budget[budget]) >= self.min_points_in_model:
                best_budget = budget
                break
        if best_budget is not None:
            self._obs = list(self._by_budget[best_budget].values())
        else:
            pooled: Dict[str, tuple] = {}
            for budget in sorted(self._by_budget):  # highest budget wins
                pooled.update(self._by_budget[budget])
            self._obs = list(pooled.values())

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        self._refresh_obs()
        return super().suggest(trial_id)

    def tell(self, config: Dict[str, Any], result: Optional[dict]) -> None:
        score = self._score(result)
        if score is not None and np.isfinite(score):
            budget = int((result or {}).get("training_iteration", 1))
            pool = self._by_budget.setdefault(budget, {})
            # Budget-qualified key: the pooled fallback in _refresh_obs
            # merges budget dicts by key, so bare counters would collide
            # across budgets and drop distinct observations.
            pool[f"told-b{budget}-{len(pool)}"] = (_flatten(config), score)
