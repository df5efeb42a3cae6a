"""The port's Tune library (``ray_tpu_torch.tune``) against ``ray_tpu.tune``.

Each of the 23 programs of ``tests/test_tune.py`` runs through both
packages, each on its own runtime (4 workers), in one module-scoped
fixture; a test per program then holds the port's outcome to the
reference's: trial configs in trial order, statuses, iterations, the best
config and metric, and error type names, exactly, float metrics at rtol
1e-12. Seeded searchers and schedulers run one trial at a time wherever
the order of reports decides the outcome (median stopping, PBT, PB2,
HyperBand, BOHB, the searchers), so that both packages see the same
sequence; the PBT and PB2 objectives train a few steps past the donor's
checkpoint they resume from, so that exploiting a finished donor still
trains. Port-only cases: four one-GPU trials on fake GPU ids under ASHA,
a Tuner over a TorchTrainer fed by a Dataset, and the imports.
"""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

import ray_tpu
import ray_tpu.train as ref_train
import ray_tpu.tune as ref_tune
import ray_tpu_torch
import ray_tpu_torch.train as port_train
import ray_tpu_torch.tune as port_tune

ROOT = Path(__file__).resolve().parent.parent

PROGRAMS = {}


def program(fn):
    PROGRAMS[fn.__name__] = fn
    return fn


def _grid_summary(grid, metric=None, mode=None):
    """What the reference's tests read off a ResultGrid: every trial's
    id, config, status, iterations and last metrics (trial order), the
    error type names, and the best result."""
    trials = [(t.trial_id, t.config, t.status.value, t.iterations,
               {k: v for k, v in t.last_result.items()},
               t.resources)
              for t in grid._trials]
    errors = [e.strip().splitlines()[-1].split(":")[0] if e else None
              for e in grid.errors]
    try:
        best = grid.get_best_result(metric, mode)
        best = (best.trial_id, best.config, best.metrics)
    except RuntimeError as e:
        best = ("raises", type(e).__name__)
    return {"trials": trials, "errors": errors, "best": best}


def _rc(train, tmp, name="exp", **kw):
    return train.RunConfig(storage_path=os.path.join(tmp, "tune"),
                           name=name, **kw)


# --------------------------------------------------------------- programs
# each takes (tune package, train package, temporary directory)


@program
def variant_generation_grid_and_samples(tune, train, tmp):
    from importlib import import_module

    gen = import_module(f"{tune.__name__}.search_space").generate_variants
    space = {"a": tune.grid_search([1, 2, 3]),
             "b": tune.choice(["x", "y"]),
             "nested": {"c": tune.grid_search([10, 20])}}
    return list(gen(space, num_samples=2, seed=0))


@program
def sampling_domains(tune, train, tmp):
    from importlib import import_module

    gen = import_module(f"{tune.__name__}.search_space").generate_variants
    space = {"lr": tune.loguniform(1e-5, 1e-1),
             "dim": tune.randint(8, 64),
             "drop": tune.quniform(0.1, 0.5, 0.1)}
    return list(gen(space, num_samples=50, seed=1))


@program
def tuner_grid_best(tune, train, tmp):
    def objective(config):
        tune.report({"score": -(config["x"] - 3) ** 2})

    return _grid_summary(tune.Tuner(
        objective,
        param_space={"x": tune.grid_search([0, 1, 2, 3, 4, 5])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    max_concurrent_trials=3),
        run_config=_rc(train, tmp)).fit())


@program
def tuner_multi_step_and_dataframe(tune, train, tmp):
    def objective(config):
        acc = 0.0
        for step in range(5):
            acc += config["lr"]
            tune.report({"acc": acc, "step": step})

    grid = tune.Tuner(
        objective,
        param_space={"lr": tune.grid_search([0.1, 0.2])},
        tune_config=tune.TuneConfig(metric="acc", mode="max"),
        run_config=_rc(train, tmp)).fit()
    df = grid.get_dataframe()
    return (_grid_summary(grid), len(df), sorted(df.columns),
            df["config/lr"].tolist())


@program
def asha_stops_bad_trials(tune, train, tmp):
    def objective(config):
        for step in range(1, 21):
            tune.report({"score": config["quality"] * step,
                         "training_iteration": step})

    sched = tune.ASHAScheduler(max_t=20, grace_period=2,
                               reduction_factor=2)
    return _grid_summary(tune.Tuner(
        objective,
        param_space={"quality": tune.grid_search(
            [5.0, 2.0, 1.0, 0.5, 0.2, 0.1])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    scheduler=sched,
                                    max_concurrent_trials=1),
        run_config=_rc(train, tmp)).fit())


@program
def median_stopping(tune, train, tmp):
    def objective(config):
        for step in range(1, 11):
            tune.report({"score": config["q"] * step})

    sched = tune.MedianStoppingRule(grace_period=3, min_samples_required=2)
    return _grid_summary(tune.Tuner(
        objective,
        param_space={"q": tune.grid_search([1.0, 1.0, 0.01])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    scheduler=sched,
                                    max_concurrent_trials=1),
        run_config=_rc(train, tmp)).fit())


@program
def trial_failure_retry(tune, train, tmp):
    marker = os.path.join(tmp, "failed_once")

    def objective(config):
        if config["x"] == 1 and not os.path.exists(marker):
            open(marker, "w").close()
            raise RuntimeError("transient")
        tune.report({"score": config["x"]})

    grid = tune.Tuner(
        objective,
        param_space={"x": tune.grid_search([1, 2])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    max_concurrent_trials=1),
        run_config=_rc(train, tmp, failure_config=train.FailureConfig(
            max_failures=1))).fit()
    return _grid_summary(grid), [t.num_failures for t in grid._trials]


@program
def trial_error_surfaces(tune, train, tmp):
    def objective(config):
        raise ValueError("boom")

    grid = tune.Tuner(
        objective, param_space={"x": tune.grid_search([1])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=_rc(train, tmp)).fit()
    return _grid_summary(grid), "boom" in grid.errors[0]


@program
def experiment_state_and_restore(tune, train, tmp):
    import json

    storage = os.path.join(tmp, "tune")

    def objective(config):
        tune.report({"score": config["x"]})

    tune.Tuner(
        objective, param_space={"x": tune.grid_search([1, 2, 3])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=train.RunConfig(storage_path=storage, name="exp1")).fit()
    exp_dir = os.path.join(storage, "exp1")
    with open(os.path.join(exp_dir, "experiment_state.json")) as f:
        state = json.load(f)
    saved = [(t["trial_id"], t["status"], t["iterations"])
             for t in state["trials"]]

    def poisoned(config):
        raise RuntimeError("must not re-run finished trials")

    grid = tune.Tuner.restore(
        exp_dir, poisoned,
        param_space={"x": tune.grid_search([1, 2, 3])}).fit()
    return saved, _grid_summary(grid, "score", "max")


@program
def checkpointed_resume(tune, train, tmp):
    def objective(config):
        import json as _json
        start = 0
        ckpt = tune.get_checkpoint()
        if ckpt:
            with open(os.path.join(ckpt.path, "s.json")) as f:
                start = _json.load(f)["step"] + 1
        for step in range(start, 6):
            d = os.path.join(tune.get_trial_dir(), f"ckpt_{step}")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "s.json"), "w") as f:
                _json.dump({"step": step}, f)
            tune.report({"score": step, "start": start}, checkpoint=d)
            if step == 2 and start == 0 and config["x"] == 1:
                raise RuntimeError("interrupt")

    grid = tune.Tuner(
        objective, param_space={"x": tune.grid_search([1])},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=_rc(train, tmp, name="ck",
                       failure_config=train.FailureConfig(
                           max_failures=1))).fit()
    ckpt = grid[0].checkpoint
    return (_grid_summary(grid), type(ckpt).__name__,
            os.path.basename(ckpt.path))


@program
def pbt_exploits_and_perturbs(tune, train, tmp):
    def objective(config):
        import json as _json
        lr = config["lr"]
        w = 0.0
        ckpt = tune.get_checkpoint()
        start = 0
        if ckpt:
            with open(os.path.join(ckpt.path, "w.json")) as f:
                st = _json.load(f)
            w, start = st["w"], st["step"] + 1
        # a trial that resumes from a finished donor trains 6 more steps
        for step in range(start, max(12, start + 6)):
            w += lr
            d = os.path.join(tune.get_trial_dir(), f"c{step}")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "w.json"), "w") as f:
                _json.dump({"w": w, "step": step}, f)
            tune.report({"score": w, "lr": lr,
                         "training_iteration": step + 1}, checkpoint=d)

    sched = tune.PopulationBasedTraining(
        perturbation_interval=3,
        hyperparam_mutations={"lr": tune.uniform(0.5, 2.0)},
        seed=0)
    grid = tune.Tuner(
        objective,
        param_space={"lr": tune.grid_search([1.0, 0.001])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    scheduler=sched,
                                    max_concurrent_trials=1),
        run_config=_rc(train, tmp, name="pbt")).fit()
    scores = sorted(t.last_result["score"] for t in grid._trials)
    return _grid_summary(grid), scores[0] > 1.0


@program
def tuner_over_trainer(tune, train, tmp):
    def loop(config):
        w = 0.0
        for _ in range(4):
            w += config["lr"]
        train.report({"w": w})

    trainer = train.DataParallelTrainer(
        loop, scaling_config=train.ScalingConfig(num_workers=2))
    grid = tune.Tuner(
        trainer,
        param_space={"lr": tune.grid_search([0.5, 1.0])},
        tune_config=tune.TuneConfig(metric="w", mode="max",
                                    max_concurrent_trials=1),
        run_config=_rc(train, tmp, name="trainer_tune")).fit()
    return ([(t.config, t.status.value, t.last_result["w"])
             for t in grid._trials], grid.errors,
            grid.get_best_result().metrics["w"])


@program
def tpe_searcher_beats_random_on_quadratic(tune, train, tmp):
    def objective(config):
        x, y = config["x"], config["y"]
        tune.report({"score": -(x - 3.0) ** 2 - (y + 1.0) ** 2})

    space = {"x": tune.uniform(-10, 10), "y": tune.uniform(-10, 10)}
    grid = tune.Tuner(
        objective, param_space=space,
        tune_config=tune.TuneConfig(
            metric="score", mode="max", num_samples=40,
            search_alg=tune.TPESearcher(n_startup=8), seed=3,
            max_concurrent_trials=1),
        run_config=_rc(train, tmp, name="tpe")).fit()
    return _grid_summary(grid)


@program
def searcher_interface_basic_variant(tune, train, tmp):
    def objective(config):
        tune.report({"score": config["a"]})

    return _grid_summary(tune.Tuner(
        objective, param_space={"a": tune.choice([1, 2, 5])},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", num_samples=6,
            search_alg=tune.BasicVariantGenerator(), seed=0,
            max_concurrent_trials=1),
        run_config=_rc(train, tmp, name="bvg")).fit())


@program
def tpe_categorical_and_log(tune, train, tmp):
    def objective(config):
        import math
        bonus = 5.0 if config["opt"] == "adam" else 0.0
        tune.report(
            {"score": bonus - abs(math.log10(config["lr"]) + 3.0)})

    space = {"lr": tune.loguniform(1e-5, 1e-1),
             "opt": tune.choice(["sgd", "adam", "rmsprop"])}
    return _grid_summary(tune.Tuner(
        objective, param_space=space,
        tune_config=tune.TuneConfig(
            metric="score", mode="max", num_samples=30,
            search_alg=tune.TPESearcher(n_startup=6), seed=1,
            max_concurrent_trials=1),
        run_config=_rc(train, tmp, name="tpelog")).fit())


@program
def restore_with_searcher(tune, train, tmp):
    def objective(config):
        tune.report({"score": -(config["x"] - 1.0) ** 2})

    space = {"x": tune.uniform(-5, 5)}
    rc = _rc(train, tmp, name="restore_tpe")
    r1 = tune.Tuner(
        objective, param_space=space,
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    num_samples=6,
                                    search_alg=tune.TPESearcher(n_startup=4),
                                    seed=0, max_concurrent_trials=1),
        run_config=rc).fit()
    exp_dir = os.path.join(rc.resolved_storage_path(), "restore_tpe")
    r2 = tune.Tuner.restore(
        exp_dir, objective, param_space=space,
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    num_samples=10,
                                    search_alg=tune.TPESearcher(n_startup=4),
                                    seed=0, max_concurrent_trials=1)).fit()
    return _grid_summary(r1), _grid_summary(r2)


def _ckpt_objective_factory(tune, optimum: float, max_steps: int):
    def objective(config):
        import json as _json
        quality = 1.0 - abs(config["x"] - optimum)
        ckpt = tune.get_checkpoint()
        start = 0
        if ckpt:
            with open(os.path.join(ckpt.path, "s.json")) as f:
                start = _json.load(f)["step"] + 1
        for step in range(start, max_steps):
            d = os.path.join(tune.get_trial_dir(), f"c{step}")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "s.json"), "w") as f:
                _json.dump({"step": step}, f)
            tune.report({"score": quality * (step + 1),
                         "training_iteration": step + 1}, checkpoint=d)
    return objective


@program
def hyperband_brackets_beat_random_budget(tune, train, tmp):
    objective = _ckpt_objective_factory(tune, optimum=0.7, max_steps=9)
    xs = [0.05, 0.2, 0.35, 0.5, 0.68, 0.9, 0.15, 0.45, 0.72]
    grid = tune.Tuner(
        objective,
        param_space={"x": tune.grid_search(xs)},
        tune_config=tune.TuneConfig(
            metric="score", mode="max",
            scheduler=tune.HyperBandScheduler(max_t=9, reduction_factor=3),
            max_concurrent_trials=1),
        run_config=_rc(train, tmp, name="hyperband")).fit()
    return _grid_summary(grid), sum(t.iterations for t in grid._trials)


@program
def bohb_beats_random_search(tune, train, tmp):
    objective = _ckpt_objective_factory(tune, optimum=0.37, max_steps=6)

    def run(search_alg, name):
        return _grid_summary(tune.Tuner(
            objective,
            param_space={"x": tune.uniform(0.0, 1.0)},
            tune_config=tune.TuneConfig(
                metric="score", mode="max", num_samples=14,
                search_alg=search_alg,
                scheduler=tune.HyperBandForBOHB(max_t=6,
                                                reduction_factor=3),
                max_concurrent_trials=1, seed=5),
            run_config=_rc(train, tmp, name=name)).fit())

    return (run(tune.BOHBSearcher(n_startup=5), "bohb"),
            run(tune.BasicVariantGenerator(), "bohb_rand"))


@program
def pb2_learns_better_configs(tune, train, tmp):
    def objective(config):
        import json as _json
        ckpt = tune.get_checkpoint()
        w, start = 0.0, 0
        if ckpt:
            with open(os.path.join(ckpt.path, "w.json")) as f:
                st = _json.load(f)
            w, start = st["w"], st["step"] + 1
        # a trial that resumes from a finished donor trains 4 more steps
        for step in range(start, max(16, start + 4)):
            lr = config["lr"]
            w += 1.0 - abs(lr - 0.6)
            d = os.path.join(tune.get_trial_dir(), f"c{step}")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "w.json"), "w") as f:
                _json.dump({"w": w, "step": step}, f)
            tune.report({"score": w, "training_iteration": step + 1},
                        checkpoint=d)

    sched = tune.PB2(hyperparam_bounds={"lr": [0.0, 1.0]},
                     perturbation_interval=3, seed=3)
    grid = tune.Tuner(
        objective,
        param_space={"lr": tune.grid_search([0.05, 0.95, 0.3, 0.85])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    scheduler=sched,
                                    max_concurrent_trials=1),
        run_config=_rc(train, tmp, name="pb2")).fit()
    return _grid_summary(grid)


@program
def resource_changing_scheduler_reallocates(tune, train, tmp):
    def objective(config):
        import json as _json
        ckpt = tune.get_checkpoint()
        start, restarts = 0, 0
        if ckpt:
            with open(os.path.join(ckpt.path, "s.json")) as f:
                st = _json.load(f)
            start, restarts = st["step"] + 1, st["restarts"] + 1
        for step in range(start, 6):
            d = os.path.join(tune.get_trial_dir(), f"c{step}")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "s.json"), "w") as f:
                _json.dump({"step": step, "restarts": restarts}, f)
            tune.report({"score": float(step), "restarts": restarts,
                         "training_iteration": step + 1}, checkpoint=d)

    def grow_after_two(total_cpus, num_running, trial, base):
        if trial.last_result.get("training_iteration", 0) >= 2:
            return {"num_cpus": 2}
        return dict(base)

    sched = tune.ResourceChangingScheduler(
        resources_allocation_function=grow_after_two)
    grid = tune.Tuner(
        objective,
        param_space={"x": tune.grid_search([0])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    scheduler=sched),
        run_config=_rc(train, tmp, name="rcs")).fit()
    return _grid_summary(grid), sched._realloc_count, sched._total_cpus


@program
def evenly_distribute_cpus_policy(tune, train, tmp):
    base = {"num_cpus": 1}
    return (tune.evenly_distribute_cpus(8.0, 2, None, base),
            tune.evenly_distribute_cpus(2.0, 4, None, base),
            tune.evenly_distribute_cpus(8.0, 0, None, base))


@program
def resource_changing_wraps_pbt_protocol(tune, train, tmp):
    pbt = tune.PopulationBasedTraining(
        perturbation_interval=2,
        hyperparam_mutations={"lr": tune.uniform(0.1, 1.0)}, seed=0)
    rcs = tune.ResourceChangingScheduler(base_scheduler=pbt)
    rcs.set_experiment("score", "max")
    pbt.pending_exploit = {"donor_id": "t1"}
    seen = rcs.pending_exploit
    rcs.pending_exploit = None
    return seen, pbt.pending_exploit, rcs.explore({"lr": 0.5})


@program
def gp_searcher_beats_random_on_quadratic(tune, train, tmp):
    def objective(config):
        x, y = config["x"], config["y"]
        tune.report({"score": -(x - 3.0) ** 2 - (y + 1.0) ** 2})

    space = {"x": tune.uniform(-10, 10), "y": tune.uniform(-10, 10)}

    def run(alg, name):
        return _grid_summary(tune.Tuner(
            objective, param_space=space,
            tune_config=tune.TuneConfig(
                metric="score", mode="max", num_samples=30,
                search_alg=alg, seed=5, max_concurrent_trials=1),
            run_config=_rc(train, tmp, name=name)).fit())

    return (run(tune.GPSearcher(n_startup=6), "gp"),
            run(tune.BasicVariantGenerator(), "gp-rnd"))


# ------------------------------------------------------------ the fixture


def _run(fn, tune, train, tmp):
    try:
        return fn(tune, train, tmp)
    except Exception as e:  # noqa: BLE001 - reported by the test
        return ("raised", type(e).__name__, str(e)[:500])


def _side(tune, train, tmp_root, side, out):
    for name, fn in PROGRAMS.items():
        d = os.path.join(tmp_root, side, name)
        os.makedirs(d)
        t0 = time.perf_counter()
        out[name] = (_run(fn, tune, train, d), time.perf_counter() - t0)


@pytest.fixture(scope="module")
def outcomes(tmp_path_factory):
    """Every program through both packages, the reference's and the
    port's halves at once in two threads, each on its own runtime."""
    root = str(tmp_path_factory.mktemp("tune"))
    ray_tpu.init(num_workers=4, object_store_memory=128 << 20)
    ray_tpu_torch.init(num_workers=4, object_store_memory=128 << 20)
    got = {"ref": {}, "port": {}}
    try:
        threads = [
            threading.Thread(target=_side, args=(
                ref_tune, ref_train, root, "ref", got["ref"])),
            threading.Thread(target=_side, args=(
                port_tune, port_train, root, "port", got["port"]))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert not any(t.is_alive() for t in threads), "a program hung"
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()
    return got


def _close(a, b, rtol=1e-12):
    if isinstance(a, float) and isinstance(b, float):
        return a == b or abs(a - b) <= rtol * max(abs(a), abs(b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k], rtol)
                                            for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y, rtol)
                                        for x, y in zip(a, b))
    return a == b and type(a) is type(b)


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_program_matches_reference(outcomes, name):
    (ref, _), (port, _) = outcomes["ref"][name], outcomes["port"][name]
    assert not (isinstance(ref, tuple) and ref[:1] == ("raised",)), \
        f"{name}: the reference raised {ref}"
    assert _close(port, ref), f"{name}:\nport {port}\nref  {ref}"


# ------------------------------------------------------------- port only


def test_gpu_trials_share_fake_gpu_ids(tmp_path, monkeypatch):
    """Four trials of ``num_gpus=1`` on one fake GPU id
    (``RTPU_GPUS=1``), up to four at once under ASHA: every trial ends,
    never two hold the id at once, and a stopped trial's id comes back
    for the next."""
    monkeypatch.setenv("RTPU_GPUS", "1")
    log = tmp_path / "held"
    log.mkdir()

    def objective(config):
        import os as _os
        import time as _time

        ids = _os.environ.get("RTPU_GPU_IDS")
        mark = _os.path.join(str(log), f"{config['q']}")
        with open(mark + ".start", "w") as f:
            f.write(f"{_time.time()} {ids}")
        try:
            for step in range(1, 9):
                port_tune.report({"score": config["q"] * step})
        finally:
            with open(mark + ".end", "w") as f:
                f.write(f"{_time.time()}")

    ray_tpu_torch.init(num_workers=4, object_store_memory=64 << 20)
    try:
        grid = port_tune.Tuner(
            objective,
            param_space={"q": port_tune.grid_search([4.0, 3.0, 2.0, 1.0])},
            tune_config=port_tune.TuneConfig(
                metric="score", mode="max", max_concurrent_trials=4,
                trial_resources={"num_gpus": 1},
                scheduler=port_tune.ASHAScheduler(
                    max_t=8, grace_period=2, reduction_factor=2)),
            run_config=port_train.RunConfig(storage_path=str(tmp_path),
                                            name="gpu")).fit()
        avail = ray_tpu_torch.core.runtime_context.get_core() \
            .state_summary()["resources"]["available"]
    finally:
        ray_tpu_torch.shutdown()
    statuses = [t.status.value for t in grid._trials]
    iters = [t.iterations for t in grid._trials]
    assert statuses == ["TERMINATED"] * 4, (statuses, grid.errors)
    assert min(iters) < 8 == max(iters), iters
    spans = []
    for q in (4.0, 3.0, 2.0, 1.0):
        start, ids = (log / f"{q}.start").read_text().split()
        spans.append((float(start), float((log / f"{q}.end").read_text()),
                      ids))
    assert {ids for _, _, ids in spans} == {"0"}, spans
    spans.sort()
    for (_, end, _), (start, _, _) in zip(spans, spans[1:]):
        assert end <= start, f"two trials held the GPU at once: {spans}"
    assert avail.get("GPU") == 1.0, avail


def test_tuner_over_a_trainer_fed_by_a_dataset(tmp_path):
    """A trial actor runs ``fit()`` of a one-worker gang whose loop reads
    its Dataset shard: the shard's feeder, a thread of the trial actor,
    reaches the split coordinator while ``fit()`` waits on the gang in
    another (a worker's waits go to the owner in slices)."""

    def loop(config):
        total = 0
        for b in port_train.get_dataset_shard("train").iter_torch_batches(
                batch_size=4, device="cpu"):
            total += int(b["id"].sum())
        port_train.report({"total": total * config["k"]})

    import ray_tpu_torch.data as port_data

    ray_tpu_torch.init(num_workers=4, object_store_memory=64 << 20)
    try:
        trainer = port_train.TorchTrainer(
            loop, torch_config=port_train.TorchConfig(device="cpu"),
            scaling_config=port_train.ScalingConfig(num_workers=1),
            datasets={"train": port_data.range(16)})
        grid = port_tune.Tuner(
            trainer, param_space={"k": port_tune.grid_search([1, 2])},
            tune_config=port_tune.TuneConfig(metric="total", mode="max",
                                             max_concurrent_trials=1),
            run_config=port_train.RunConfig(storage_path=str(tmp_path),
                                            name="fed")).fit()
    finally:
        ray_tpu_torch.shutdown()
    assert not grid.errors, grid.errors
    assert [t.last_result["total"] for t in grid._trials] == [120, 240]


def test_tune_import_loads_no_torch_pandas_scipy_jax():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, builtins\n"
         "seen = []\n"
         "real = builtins.__import__\n"
         "def spy(name, *a, **k):\n"
         "    if name.split('.')[0] in ('jax', 'ray_tpu'):\n"
         "        seen.append(name)\n"
         "    return real(name, *a, **k)\n"
         "builtins.__import__ = spy\n"
         "import ray_tpu_torch.tune\n"
         "print(*[m in sys.modules for m in "
         "('torch', 'pandas', 'scipy')], seen)"],
        cwd=ROOT, capture_output=True, text=True, check=True, timeout=120)
    assert out.stdout.split() == ["False", "False", "False", "[]"], \
        out.stdout


def test_tune_all_is_the_reference_all():
    assert port_tune.__all__ == ref_tune.__all__
    assert all(hasattr(port_tune, n) for n in port_tune.__all__)
