"""ray_tpu_torch.tune's host logic against the JAX package's, with no
runtime: each case feeds the same seeds, scripted result streams and
searcher histories to a module of ``ray_tpu/tune/`` and to its port in
``ray_tpu_torch/tune/`` and holds them to exact equality -- variants,
scheduler decisions (PBT's donors and perturbed configs too), stopper
verdicts, searcher suggestions -- and the syncer's mirror, its dispatch
and its failure without boto3. Cases the reference's tests repeat are
cases of one parametrised test here.
"""

import sys

import numpy as np
import pytest

from ray_tpu import tune as jtune
from ray_tpu.tune import schedulers as jsched
from ray_tpu.tune import search as jsearch
from ray_tpu.tune import search_space as jspace
from ray_tpu.tune import stopper as jstop
from ray_tpu.tune import syncer as jsync
from ray_tpu_torch import tune as ttune
from ray_tpu_torch.tune import schedulers as tsched
from ray_tpu_torch.tune import search as tsearch
from ray_tpu_torch.tune import search_space as tspace
from ray_tpu_torch.tune import stopper as tstop
from ray_tpu_torch.tune import syncer as tsync

PKGS = {"jax": (jtune, jspace, jsched, jsearch, jstop, jsync),
        "port": (ttune, tspace, tsched, tsearch, tstop, tsync)}


def _const(_spec):
    return 7


def _seven():
    return 7


# -- search spaces ----------------------------------------------------------


def _spaces(t):
    return {
        "grid_and_samples": {
            "lr": t.grid_search([0.1, 0.01]),
            "bs": t.grid_search([8, 16]),
            "wd": t.uniform(0.0, 1.0),
            "depth": t.randint(1, 5),
            "act": t.choice(["relu", "gelu"])},
        "each_domain": {
            "u": t.uniform(-2.0, 3.0), "q": t.quniform(0.0, 1.0, 0.25),
            "l": t.loguniform(1e-4, 1e-1), "i": t.randint(0, 100),
            "c": t.choice(["a", "b", "c", 4]), "s": t.sample_from(_const),
            "fixed": 3},
        "nested": {
            "opt": {"lr": t.loguniform(1e-5, 1e-2),
                    "betas": {"b1": t.uniform(0.8, 0.95)}},
            "layers": t.grid_search([2, 4, 8]), "name": "x"},
        "grid_only": {"x": t.grid_search([0.0, 1.0, 3.0, 5.0])},
    }


@pytest.mark.parametrize("name", ["grid_and_samples", "each_domain",
                                  "nested", "grid_only"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("num_samples", [1, 3])
def test_generate_variants_are_the_references(name, seed, num_samples):
    want = jspace.generate_variants(_spaces(jtune)[name], num_samples, seed)
    got = tspace.generate_variants(_spaces(ttune)[name], num_samples, seed)
    assert got == want
    assert len(got) == len(want) > 0


@pytest.mark.parametrize("dom", ["uniform", "quniform", "loguniform",
                                 "randint", "choice"])
def test_each_domain_draws_the_references_values(dom):
    args = {"uniform": (0.5, 2.0), "quniform": (0.0, 10.0, 0.5),
            "loguniform": (1e-4, 1e-1), "randint": (3, 9),
            "choice": ([1, "two", 3.0],)}[dom]
    rj, rt = np.random.default_rng(3), np.random.default_rng(3)
    dj, dt = getattr(jtune, dom)(*args), getattr(ttune, dom)(*args)
    got = [dt.sample(rt) for _ in range(50)]
    assert got == [dj.sample(rj) for _ in range(50)]
    if dom == "loguniform":
        assert all(1e-4 <= v <= 1e-1 for v in got)
    with pytest.raises(ValueError):
        ttune.loguniform(0.0, 1.0)


# -- schedulers -------------------------------------------------------------


class _Trial:
    def __init__(self, trial_id):
        self.trial_id = trial_id


class _Runner:
    """Records PBT's exploits: (trial, donor, the perturbed config)."""

    def __init__(self, configs):
        self.configs = configs
        self.exploits = []

    def _pbt_exploit(self, trial, donor_id, scheduler):
        new = scheduler.perturb_config(self.configs[donor_id])
        self.exploits.append((trial.trial_id, donor_id, new))
        self.configs[trial.trial_id] = new


def _stream(seed, n_trials, max_t, interleave=True, missing=False):
    """A scripted result stream: (trial id, result) in arrival order,
    each trial's metric a noisy curve of its own quality."""
    rng = np.random.default_rng(seed)
    quality = rng.uniform(0.1, 2.0, n_trials)
    events = [(i, t) for i in range(n_trials) for t in range(1, max_t + 1)]
    if interleave:
        # Trials in a random order of arrival, each trial's own results
        # in time order.
        seen, arrivals = {}, []
        for k in rng.permutation(len(events)):
            i = events[k][0]
            seen[i] = seen.get(i, 0) + 1
            arrivals.append((i, seen[i]))
        events = arrivals
    out = []
    for i, t in events:
        r = {"training_iteration": t,
             "score": float(quality[i] * t + rng.normal(0, 0.3))}
        if missing and rng.uniform() < 0.1:
            del r["score"]
        out.append((f"t{i}", r))
    return out


def _feed(sched, stream, runner=None):
    trials = {}
    out = []
    for tid, result in stream:
        tr = trials.setdefault(tid, _Trial(tid))
        out.append(sched.on_trial_result(runner, tr, dict(result)))
    return out


@pytest.mark.parametrize("mode", ["max", "min"])
@pytest.mark.parametrize("grace,rf,max_t", [(1, 4, 16), (2, 2, 12),
                                            (3, 3, 27)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_asha_decisions_are_the_references(mode, grace, rf, max_t, seed):
    stream = _stream(seed, 8, max_t, missing=seed == 2)
    kw = dict(metric="score", mode=mode, max_t=max_t, grace_period=grace,
              reduction_factor=rf)
    want = _feed(jsched.ASHAScheduler(**kw), stream)
    got = _feed(tsched.ASHAScheduler(**kw), stream)
    assert got == want
    assert tsched.STOP in got  # the streams do stop trials


@pytest.mark.parametrize("max_t,eta,brackets", [(27, 3, 3), (9, 3, 2),
                                                (16, 2, 4)])
@pytest.mark.parametrize("seed", [0, 1])
def test_hyperband_brackets_and_decisions_are_the_references(
        max_t, eta, brackets, seed):
    stream = _stream(seed, 9, max_t)
    kw = dict(metric="score", mode="max", max_t=max_t, eta=eta,
              brackets=brackets)
    j, t = jsched.HyperBandScheduler(**kw), tsched.HyperBandScheduler(**kw)
    assert [b.grace for b in t.brackets] == [b.grace for b in j.brackets]
    assert [sorted(b.rungs) for b in t.brackets] == \
        [sorted(b.rungs) for b in j.brackets]
    assert _feed(t, stream) == _feed(j, stream)
    assert t._assignment == j._assignment
    if max_t == 9:
        assert t.brackets[0].grace == 9 and t.brackets[1].grace == 3


@pytest.mark.parametrize("mode", ["max", "min"])
@pytest.mark.parametrize("grace,min_samples", [(1, 3), (2, 2)])
@pytest.mark.parametrize("seed", [0, 1])
def test_median_stopping_decisions_are_the_references(mode, grace,
                                                      min_samples, seed):
    stream = _stream(seed, 6, 8)
    kw = dict(metric="score", mode=mode, grace_period=grace,
              min_samples_required=min_samples)
    got = _feed(tsched.MedianStoppingRule(**kw), stream)
    assert got == _feed(jsched.MedianStoppingRule(**kw), stream)
    assert tsched.STOP in got and tsched.CONTINUE in got


@pytest.mark.parametrize("mutations", [
    {"lr": (0.001, 1.0)},
    {"lr": [0.01, 0.02, 0.05], "wd": (0.0, 0.5)},
    {"lr": [3e-4, 1e-4], "k": _seven},
])
@pytest.mark.parametrize("quantile,interval", [(0.25, 4), (0.5, 2)])
@pytest.mark.parametrize("seed", [0, 5])
def test_pbt_donors_and_perturbations_are_the_references(
        mutations, quantile, interval, seed):
    stream = _stream(seed, 6, 12)
    configs = {f"t{i}": {"lr": 0.01 * (i + 1), "wd": 0.1, "k": 1}
               for i in range(6)}
    runs = {}
    for pkg, mod in (("jax", jsched), ("port", tsched)):
        runner = _Runner({k: dict(v) for k, v in configs.items()})
        sched = mod.PopulationBasedTraining(
            metric="score", mode="max", perturbation_interval=interval,
            hyperparam_mutations=mutations, quantile_fraction=quantile,
            seed=seed)
        runs[pkg] = (_feed(sched, stream, runner), runner.exploits,
                     runner.configs)
    assert runs["port"] == runs["jax"]
    assert runs["port"][1]  # exploits happened


# -- stoppers ---------------------------------------------------------------


def _stoppers(t, s):
    return {
        "max_iter": s.MaximumIterationStopper(5),
        "plateau": s.TrialPlateauStopper("score", std=0.4, num_results=3,
                                         grace_period=4),
        "function": s.FunctionStopper(
            lambda tid, r: r["score"] > 10 and tid != "t0"),
        "combined": s.CombinedStopper(
            s.MaximumIterationStopper(9),
            s.TrialPlateauStopper("score", std=0.2, num_results=4)),
        "dict": s.coerce_stopper({"score": 8.0, "other": 1}),
        "callable": s.coerce_stopper(
            lambda tid, r: r["training_iteration"] % 7 == 0),
    }


@pytest.mark.parametrize("name", ["max_iter", "plateau", "function",
                                  "combined", "dict", "callable"])
def test_stopper_verdicts_are_the_references(name):
    stream = _stream(4, 4, 12)
    j, t = _stoppers(jtune, jstop)[name], _stoppers(ttune, tstop)[name]
    got = [t(tid, r) for tid, r in stream]
    assert got == [j(tid, r) for tid, r in stream]
    assert t.stop_all() == j.stop_all() is False
    assert any(got)


def test_coerce_stopper_forms():
    s = tstop.MaximumIterationStopper(2)
    assert tstop.coerce_stopper(None) is None
    assert tstop.coerce_stopper(s) is s
    with pytest.raises(TypeError, match="Stopper, dict, or callable"):
        tstop.coerce_stopper(3)


# -- searchers --------------------------------------------------------------


def _objective(cfg):
    x = cfg.get("x", 0.0)
    y = cfg.get("y", 1.0)
    n = cfg.get("n", 7)
    cat = 0.0 if cfg.get("act", "b") == "b" else 1.5
    q = cfg.get("nested", {}).get("q", 0.5)
    return -((x - 2.0) ** 2) - (np.log10(y) + 1.0) ** 2 - abs(n - 7) * 0.1 \
        - cat - abs(q - 0.5)


def _search_space(t):
    return {"x": t.uniform(-10.0, 10.0), "y": t.loguniform(1e-4, 1e2),
            "n": t.randint(1, 20), "act": t.choice(["a", "b", "c"]),
            "nested": {"q": t.quniform(0.0, 1.0, 0.25)}}


def _drive(searcher, n, mode="max", budgets=False):
    out = []
    for i in range(n):
        tid = f"t{i}"
        cfg = searcher.suggest(tid)
        out.append(cfg)
        score = _objective(cfg)
        if mode == "min":
            score = -score
        if budgets:
            for it in (1, 3):
                searcher.on_trial_result(
                    tid, {"score": score * it / 3, "training_iteration": it})
        searcher.on_trial_complete(tid, {"score": score,
                                         "training_iteration": 3})
    return out


@pytest.mark.parametrize("multivariate", [False, True, "auto"])
@pytest.mark.parametrize("mode", ["max", "min"])
@pytest.mark.parametrize("seed", [0, 3])
def test_tpe_suggestions_are_the_references(multivariate, mode, seed):
    runs = {}
    for pkg, (t, _sp, _sc, se, _st, _sy) in PKGS.items():
        s = se.TPESearcher(metric="score", mode=mode,
                           param_space=_search_space(t), n_initial=6,
                           seed=seed, multivariate=multivariate)
        runs[pkg] = _drive(s, 24, mode)
        s.tell({"x": 1.0, "y": 0.1, "n": 3, "act": "a",
                "nested": {"q": 0.25}}, {"score": 0.5})
        runs[pkg].append(s.suggest("after-tell"))
    assert runs["port"] == runs["jax"]


@pytest.mark.parametrize("seed", [0, 1])
def test_tpe_late_bound_space_and_conflict_are_the_references(seed):
    runs = {}
    for pkg, (t, _sp, _sc, se, _st, _sy) in PKGS.items():
        s = se.TPESearcher(n_initial=4, seed=seed)
        assert s.set_search_properties("score", "max",
                                       {"x": t.uniform(0.0, 10.0)})
        fixed = se.TPESearcher(param_space={"y": t.uniform(0, 1)})
        assert not fixed.set_search_properties("score", "max",
                                               {"x": t.uniform(0, 1)})
        runs[pkg] = _drive(s, 12)
    assert runs["port"] == runs["jax"]
    with pytest.raises(ValueError, match="no search space"):
        tsearch.TPESearcher().suggest("t0")


@pytest.mark.parametrize("min_points", [4, 6])
@pytest.mark.parametrize("seed", [0, 1])
def test_bohb_suggestions_and_budgets_are_the_references(min_points, seed):
    runs = {}
    for pkg, (t, _sp, _sc, se, _st, _sy) in PKGS.items():
        s = se.BOHBSearcher(metric="score", mode="max",
                            param_space={"x": t.uniform(0, 1),
                                         "y": t.loguniform(1e-3, 1.0)},
                            n_initial=4, min_points_in_model=min_points,
                            seed=seed)
        out = _drive(s, 14, budgets=True)
        for i, x in enumerate(np.linspace(0.05, 0.95, 8)):
            s.tell({"x": float(x), "y": 0.1},
                   {"score": -abs(float(x) - 0.8), "training_iteration": 9})
        out += [s.suggest(f"c{i}") for i in range(6)]
        s._refresh_obs()
        runs[pkg] = (out, {b: sorted(p) for b, p in s._by_budget.items()},
                     len(s._obs))
    assert runs["port"] == runs["jax"]


@pytest.mark.parametrize("num_samples", [1, 2])
def test_basic_variant_searcher_deals_the_references_variants(num_samples):
    got, want = [], []
    for pkg, out in (("jax", want), ("port", got)):
        t, _sp, _sc, se, _st, _sy = PKGS[pkg]
        s = se.BasicVariantSearcher(
            {"x": t.grid_search([1, 2, 3]), "u": t.uniform(0, 1)},
            num_samples=num_samples, seed=4)
        assert s.expands_variants
        while (c := s.suggest(f"t{len(out)}")) is not None:
            out.append(c)
    assert got == want and len(got) == 3 * num_samples


@pytest.mark.parametrize("fn", ["parzen", "bw"])
def test_tpe_kernels_are_the_references(fn):
    rng = np.random.default_rng(0)
    centers = rng.uniform(0, 1, 7)
    x = rng.uniform(0, 1, 11)
    if fn == "bw":
        for c in (centers, np.array([]), np.array([0.5])):
            np.testing.assert_array_equal(tsearch._adaptive_bw(c),
                                          jsearch._adaptive_bw(c))
    else:
        bws = jsearch._adaptive_bw(centers)
        for c, b in ((centers, bws), (np.array([]), np.array([]))):
            np.testing.assert_array_equal(
                tsearch._parzen_logpdf(x, c, b),
                jsearch._parzen_logpdf(x, c, b))


# -- syncer -----------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_file_syncer_incremental_mirror(tmp_path, pkg):
    import os

    sync = PKGS[pkg][5]
    src, dst = tmp_path / "src", tmp_path / "dst"
    src.mkdir()
    (src / "a.txt").write_text("one")
    (src / "sub").mkdir()
    (src / "sub" / "b.txt").write_text("two")
    s = sync.FileSyncer()
    assert s.sync_up(str(src), f"file://{dst}")
    assert (dst / "a.txt").read_text() == "one"
    assert (dst / "sub" / "b.txt").read_text() == "two"
    # Incremental: a changed file is copied again; a deletion does not
    # propagate (the remote history stays).
    (src / "a.txt").write_text("one-v2")
    os.remove(src / "sub" / "b.txt")
    assert s.sync_up(str(src), f"file://{dst}")
    assert (dst / "a.txt").read_text() == "one-v2"
    assert (dst / "sub" / "b.txt").read_text() == "two"
    down = tmp_path / "down"
    assert s.sync_down(f"file://{dst}", str(down))
    assert (down / "a.txt").read_text() == "one-v2"
    assert not s.sync_down(f"file://{tmp_path}/absent", str(down))
    assert s.delete(f"file://{dst}") and not dst.exists()


def test_get_syncer_dispatch_is_the_references():
    for uri in ("file:///x", "/plain/path", "s3://b/k", "gs://b/x",
                "rel/path", "file://"):
        assert tsync.is_remote_uri(uri) == jsync.is_remote_uri(uri), uri
    assert isinstance(tsync.get_syncer("file:///x"), tsync.FileSyncer)
    assert isinstance(tsync.get_syncer("/plain/path"), tsync.FileSyncer)
    with pytest.raises(ValueError, match="no syncer registered"):
        tsync.get_syncer("gs://bucket/x")

    class GsSyncer(tsync.FileSyncer):
        pass

    tsync.register_syncer("gs", GsSyncer)
    try:
        assert tsync.is_remote_uri("gs://bucket/x")
        assert isinstance(tsync.get_syncer("gs://bucket/x"), GsSyncer)
    finally:
        del tsync._SCHEMES["gs"]


def test_periodic_sync_throttles_and_final_always_syncs(tmp_path):
    calls = []

    class Counting(tsync.FileSyncer):
        sync_period = 3600.0

        def sync_up(self, local_dir, remote_uri):
            calls.append((local_dir, remote_uri))
            return True

    p = tsync._PeriodicSync(Counting(), str(tmp_path), "file:///r")
    p.maybe_sync()
    p.maybe_sync()
    assert len(calls) == 1
    p.final()
    assert len(calls) == 2


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_s3_fails_clearly_without_boto3(monkeypatch, pkg):
    monkeypatch.setitem(sys.modules, "boto3", None)  # import fails
    sync = PKGS[pkg][5]
    with pytest.raises(RuntimeError, match="requires boto3") as exc:
        sync.get_syncer("s3://bucket/exp")
    assert isinstance(exc.value.__cause__, ImportError)


def test_tune_exports_are_the_references():
    assert sorted(ttune.__all__) == sorted(jtune.__all__)
    for name in ttune.__all__:
        assert hasattr(ttune, name), name
