"""kstar_torch's hyper-parameter search (ASHA, TPE, grouped trials, hpo_run)
against kstar_tpu's, on the CPU.

* The samplers and ``run_asha`` are numpy copies: for the same
  ``np.random.Generator`` seed and the same deterministic trainable they
  must give the same configs and write the same trial log, bit for bit, for
  random and TPE search, serially and on a 2-worker pool.
* ``make_hpo_optimizer`` + ``set_learning_rate`` must equal
  ``make_optimizer`` at that rate (and JAX's injected-rate optimizer) over 6
  steps with the staircase, for all four optimizers.
* A group trainable (``run_asha``'s ``group_trainable``) writes the serial
  run's trial log, in both packages.
* ``hpo_run`` takes JAX's options plus ``--device`` and samples JAX's
  configs; ``--hpo_vmap`` (the serial trainable in the port) gives the
  serial run's trials.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

from kstar_torch.train import hpo as th
from kstar_torch.train import tpe as ttpe
from kstar_tpu.train import hpo as jh
from kstar_tpu.train import tpe as jtpe

SPACES = [("0D", m) for m in ("Transformer", "CnnLSTM", "MLSTM_FCN")] + \
         [("video", m) for m in ("ViViT", "R2Plus1D", "SlowFast")]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _space(pkg, kind, model):
    return (pkg.search_space_0d if kind == "0D" else pkg.search_space_video)(model)


@pytest.mark.parametrize("kind,model", SPACES)
def test_search_spaces_sample_jax_configs(kind, model):
    rt, rj = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(20):
        assert th.sample_config(_space(th, kind, model), rt) == \
            jh.sample_config(_space(jh, kind, model), rj)


def test_distributions_draw_as_jax():
    for name, args in (("uniform", (0.5, 4.0)), ("loguniform", (1e-4, 1e-2)),
                       ("choice", ([16, 32, 64],)), ("randint", (1, 6))):
        t, j = getattr(th, name)(*args), getattr(jh, name)(*args)
        rt, rj = np.random.default_rng(3), np.random.default_rng(3)
        assert [t(rt) for _ in range(50)] == [j(rj) for _ in range(50)]
        assert t.kind == j.kind == name


def _tpe_space(pkg):
    return {"lr": pkg.loguniform(1e-4, 1e-2), "u": pkg.uniform(0.0, 1.0),
            "n": pkg.randint(1, 6), "c": pkg.choice(["a", "b", (1, 2)]),
            "pinned": pkg.uniform(0.3, 0.3)}


def test_tpe_sampler_proposes_jax_configs():
    st, sj = ttpe.TPESampler(_tpe_space(th)), jtpe.TPESampler(_tpe_space(jh))
    rng = np.random.default_rng(0)
    assert st.sample(np.random.default_rng(1)) == sj.sample(np.random.default_rng(1))
    for _ in range(15):
        cfg = jh.sample_config(_tpe_space(jh), rng)
        score = float(rng.uniform()) if cfg["c"] != "b" else float("nan")
        st.observe(cfg, score)
        sj.observe(cfg, score)
    rt, rj = np.random.default_rng(2), np.random.default_rng(2)
    assert [st.sample(rt) for _ in range(10)] == [sj.sample(rj) for _ in range(10)]


def _fake_trainable(config, n_epochs, state, device=None):
    """Deterministic: the score approaches a quality set by the config."""
    done = state or 0
    q = 1.0 / (1.0 + (np.log10(config["lr"]) + 3.0) ** 2) + 0.1 * config["u"]
    return done + n_epochs, [q * (1 - 0.5 ** (done + e + 1)) for e in range(n_epochs)]


@pytest.mark.parametrize("search", ["random", "tpe"])
def test_run_asha_writes_jax_trial_log(tmp_path, search):
    kw = dict(n_trials=10, max_epochs=8, grace_period=2, reduction_factor=2, seed=11,
              search=search, tpe_startup=4, tpe_batch=3)
    space = lambda pkg: {"lr": pkg.loguniform(1e-5, 1e-1), "u": pkg.uniform(0, 1)}
    jbest, _ = jh.run_asha(_fake_trainable, space(jh), log_path=os.fspath(tmp_path / "j.json"),
                           **kw)
    tbest, _ = th.run_asha(_fake_trainable, space(th), log_path=os.fspath(tmp_path / "t.json"),
                           **kw)
    cpus = [torch.device("cpu"), torch.device("cpu")]
    pbest, _ = th.run_asha(_fake_trainable, space(th), log_path=os.fspath(tmp_path / "p.json"),
                           n_workers=2, devices=cpus, **kw)
    log = (tmp_path / "j.json").read_text()
    assert (tmp_path / "t.json").read_text() == log
    assert (tmp_path / "p.json").read_text() == log
    assert tbest.trial_id == pbest.trial_id == jbest.trial_id
    assert len({t["epochs"] for t in json.loads(log)}) >= 2      # the bracket halved


# ---------------------------------------------------------------------------
# the grouped trials' optimizer names
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sgd", "adam", "rmsprop", "adamw"])
def test_hpo_optimizer_equals_make_optimizer(name):
    import jax.numpy as jnp
    import optax
    import optax.tree_utils as otu

    from kstar_torch.config import OptimConfig
    from kstar_torch.train import TrainState, make_optimizer
    from kstar_torch.train.hpo_vmap import make_hpo_optimizer, set_learning_rate
    from kstar_tpu.config import OptimConfig as JOptimConfig
    from kstar_tpu.train.hpo_vmap import make_hpo_optimizer as j_make_hpo_optimizer

    kw = dict(optimizer=name, use_scheduler=True, step_size=2, gamma=0.5, max_norm_grad=1.0)
    w0, b0 = np.arange(4, dtype=np.float32), np.full(2, -1.5, np.float32)
    grads = [(np.full(4, 0.7 * (k + 1), np.float32), np.array([3.0, -0.2], np.float32) / (k + 1))
             for k in range(6)]

    def run(tx, lr=None):
        model = torch.nn.ParameterDict({"b": torch.nn.Parameter(torch.tensor(b0)),
                                        "w": torch.nn.Parameter(torch.tensor(w0))})
        st = TrainState(model, tx)
        if lr is not None:
            set_learning_rate(st, lr)
        for gw, gb in grads:        # 6 steps cross the step_size=2 boundary twice
            model["w"].grad, model["b"].grad = torch.tensor(gw), torch.tensor(gb)
            st.apply_gradients(torch.tensor(True), None)
        return st.flat.numpy()

    want = run(make_optimizer(OptimConfig(lr=1e-2, **kw)))
    got = run(make_hpo_optimizer(OptimConfig(lr=1e-3, **kw)), lr=1e-2)
    np.testing.assert_allclose(got, want, atol=1e-6)

    jtx = j_make_hpo_optimizer(JOptimConfig(lr=1e-3, **kw))
    p = {"b": jnp.asarray(b0), "w": jnp.asarray(w0)}
    s = otu.tree_set(jtx.init(p), learning_rate=jnp.float32(1e-2))
    for gw, gb in grads:
        u, s = jtx.update({"b": jnp.asarray(gb), "w": jnp.asarray(gw)}, s, p)
        p = optax.apply_updates(p, u)
    np.testing.assert_allclose(got, np.concatenate([p["b"], p["w"]]), atol=1e-6)


# ---------------------------------------------------------------------------
# run_asha's group seam against the serial trainable
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("search", ["random", "tpe"])
def test_group_trainable_equals_serial(tmp_path, search):
    """A group trainable that advances each same-architecture group in one
    call writes the serial run's trial log, in both packages."""
    kw = dict(n_trials=10, max_epochs=8, grace_period=2, reduction_factor=2, seed=11,
              search=search, tpe_startup=4, tpe_batch=3)
    # "u" is an architecture key (group_key), so the rungs form groups of several
    space = lambda pkg: {"lr": pkg.loguniform(1e-5, 1e-1), "u": pkg.choice([0.0, 0.5])}
    sizes = []

    def group(configs, n_epochs, states):
        sizes.append(len(configs))
        out = [_fake_trainable(c, n_epochs, s) for c, s in zip(configs, states)]
        return [st for st, _ in out], [sc for _, sc in out]

    def poison(*a, **k):
        raise AssertionError("group_trainable was bypassed")

    sbest, _ = th.run_asha(_fake_trainable, space(th), log_path=os.fspath(tmp_path / "s.json"),
                           **kw)
    gbest, _ = th.run_asha(poison, space(th), log_path=os.fspath(tmp_path / "g.json"),
                           group_trainable=group, **kw)
    jbest, _ = jh.run_asha(poison, space(jh), log_path=os.fspath(tmp_path / "j.json"),
                           group_trainable=group, **kw)
    log = (tmp_path / "s.json").read_text()
    assert (tmp_path / "g.json").read_text() == log
    assert (tmp_path / "j.json").read_text() == log
    assert sbest.trial_id == gbest.trial_id == jbest.trial_id
    assert max(sizes) > 1


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _parser_of(main):
    """The argparse parser ``main`` builds (captured at ``parse_args``)."""
    class Captured(Exception):
        pass

    orig = argparse.ArgumentParser.parse_args

    def grab(self, *a, **k):
        raise Captured(self)

    argparse.ArgumentParser.parse_args = grab
    try:
        main([])
    except Captured as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = orig
    raise AssertionError("main did not parse its arguments")


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type,
                     tuple(a.choices) if a.choices else None, a.nargs)
            for a in parser._actions if a.dest != "help"}


def test_hpo_run_options_are_jax_options_plus_device():
    from kstar_torch.cli import hpo_run
    from kstar_tpu.cli import hpo_run as j_hpo_run

    ours = _options(hpo_run.build_parser())
    theirs = _options(_parser_of(j_hpo_run.main))
    assert ours.pop("device") == (("--device",), "cuda", str, None, None)
    assert ours == theirs


TINY_HPO = ["--model", "MLSTM_FCN", "--synthetic", "--device", "cpu", "--n_trials", "2",
            "--max_epochs", "2", "--grace_period", "1", "--synthetic_shots", "6",
            "--random_seed", "4"]


def test_hpo_run_cpu_samples_jax_configs(tmp_path, capsys):
    from kstar_torch.cli import hpo_run

    logs = {}
    for name, extra in (("serial", []), ("grouped", ["--hpo_vmap"])):
        best, results = hpo_run.main(TINY_HPO + ["--save_dir", os.fspath(tmp_path / name)]
                                     + extra)
        out = capsys.readouterr().out
        assert f"best trial {best.trial_id}: valid F1" in out
        assert f"test macro-F1 {results['macro_f1']:.4f}" in out
        logs[name] = json.loads((tmp_path / name / "hpo_MLSTM_FCN.json").read_text())
    rng = np.random.default_rng(4)
    want = [jh.sample_config(jh.search_space_0d("MLSTM_FCN"), rng) for _ in range(2)]
    assert [t["config"] for t in logs["serial"]] == json.loads(json.dumps(want))
    for a, b in zip(logs["serial"], logs["grouped"]):
        assert (a["config"], a["epochs"]) == (b["config"], b["epochs"])
        np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-6)
    with pytest.raises(SystemExit, match="--hpo_vmap supports the 0D models only"):
        hpo_run.main(["--model", "ViViT", "--hpo_vmap", "--synthetic", "--device", "cpu"])
