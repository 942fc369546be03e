"""The repository's experiment layer through the port, on the CPU.

* ``kstar_torch.analysis.demos``' argument lists equal the flags of
  ``exp/demo_vivit.sh`` and ``exp/demo_multimodal.sh`` (and of the variants
  its header lists), parsed from the shell text with ``shlex``.
* Each grid twin ``exp/torch_exp_*.sh`` equals its original but for
  ``kstar_tpu`` -> ``kstar_torch`` and ``--save_dir ./results/torch
  --weight_dir ./weights/torch`` before each ``"$@"``.
* The ViViT demo at tiny widths and one epoch (extra flags override) writes
  ``demo_vivit_alarms.json`` with the keys of ``results/demo_vivit_alarms.json``
  into a temporary directory and leaves the demo's files in ``./results``
  and ``./weights`` as they were; the JAX directories are refused as
  targets.
* ``kstar_torch.analysis.eda`` prints the lines ``analysis/eda.py`` prints on
  the same synthetic data; ``xai_demo`` runs at a tiny size;
  ``analysis/aggregate_results.py`` parses the port's report.
"""

import importlib.util
import json
import os
import re
import shlex
from pathlib import Path

import numpy as np
import pytest
import torch

from kstar_torch.analysis import demos, eda, xai_demo

ROOT = Path(__file__).resolve().parents[1]
TINY = ["--num_epoch", "1", "--synthetic_shots", "8",
        "--synthetic_normal", "1", "--synthetic_eval_disrupt", "1",
        "--synthetic_eval_normal", "1", "--synthetic_frames", "240", "--dist", "21",
        "--dim", "32", "--depth", "1", "--n_heads", "2", "--d_head", "16",
        "--scale_dim", "2", "--image_size", "32", "--batch_size", "8"]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _script_module(path: Path):
    """A root-level script (analysis/*.py) loaded as a module by its path."""
    spec = importlib.util.spec_from_file_location(f"_script_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _shell_command(path: Path) -> list:
    """The flags of the script's ``python -m kstar_tpu.cli.* ... "$@"`` line."""
    text = path.read_text().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines() if "python -m kstar_tpu.cli." in ln)
    words = shlex.split(line)
    assert words[-1] == "$@"
    return words[3:-1]


def _header_variants(path: Path) -> dict:
    """exp/demo_multimodal.sh's header variants: tag -> the flags it adds."""
    lines = [ln[1:].strip() for ln in path.read_text().splitlines() if ln.startswith("#")]
    text = " ".join(lines).replace("\\ ", " ")
    out = {}
    for m in re.finditer(r"(--pair_mode .*?--tag (\S+))", text):
        out[m.group(2)] = shlex.split(m.group(1))
    return out


def test_vivit_list_equals_the_shell_script():
    assert demos.DEMOS["vivit"] == ("train_vision", _shell_command(ROOT / "exp/demo_vivit.sh"))
    assert "python -m kstar_tpu.cli.train_vision" in (ROOT / "exp/demo_vivit.sh").read_text()


@pytest.mark.parametrize("name", ["multimodal", "multimodal_aligned",
                                  "multimodal_aligned_normal"])
def test_multimodal_lists_equal_the_shell_script(name):
    path = ROOT / "exp/demo_multimodal.sh"
    base = _shell_command(path)
    variants = _header_variants(path)
    assert sorted(variants) == ["demo_multimodal_aligned", "demo_multimodal_aligned_normal"]
    tag = "demo_" + name
    want = base + variants.get(tag, [])
    assert demos.DEMOS[name] == ("train_multimodal", want)
    assert demos.last_value(want, "--tag") == tag


GRIDS = ["exp_vivit.sh", "exp_r2plus1d.sh", "exp_0d_mlstm.sh", "exp_la_vivit.sh",
         "exp_la_0D.sh", "exp_multi.sh"]


@pytest.mark.parametrize("name", GRIDS)
def test_grid_twin_equals_its_original(name):
    original = (ROOT / "exp" / name).read_text()
    twin = (ROOT / "exp" / f"torch_{name}").read_text()
    assert original.count('"$@"') >= 1
    assert twin == original.replace("kstar_tpu", "kstar_torch").replace(
        '"$@"', '--save_dir ./results/torch --weight_dir ./weights/torch "$@"')
    assert os.access(ROOT / "exp" / f"torch_{name}", os.X_OK)


@pytest.mark.parametrize("name", ["torch_demo_vivit.sh", "torch_demo_multimodal.sh"])
def test_demo_twins_call_the_port(name):
    text = (ROOT / "exp" / name).read_text()
    demo = name[len("torch_demo_"):-len(".sh")]
    assert f'python -m kstar_torch.analysis.demos {demo} "$@"' in text
    assert "kstar_tpu" not in text


def _tree(path: Path) -> dict:
    """The demo's files under ``path`` (other tests may write elsewhere in
    it while this one runs) with their modification times."""
    return {str(p): p.stat().st_mtime_ns for p in path.rglob("*demo_vivit*")}


@pytest.fixture(scope="module")
def vivit_demo(tmp_path_factory):
    out = tmp_path_factory.mktemp("demo")
    before = {d: _tree(ROOT / d) for d in ("results", "weights")}
    res = demos.main("vivit", TINY, save_dir=str(out / "r"), weight_dir=str(out / "w"),
                     device="cpu")
    return res, out, before


def test_vivit_demo_writes_jax_keys_and_leaves_jax_results(vivit_demo):
    res, out, before = vivit_demo
    jax_file = json.loads((ROOT / "results/demo_vivit_alarms.json").read_text())
    port_file = json.loads((out / "r" / "demo_vivit_alarms.json").read_text())
    assert set(port_file) == set(jax_file)
    assert res["tag"] == "demo_vivit" and res["alarms"] == port_file
    assert res["jax_alarms"] == jax_file
    assert port_file["min_dwell_s"] == 0.15 and port_file["n_disrupt"] == 2
    assert (out / "w" / "demo_vivit_best.ckpt").exists()
    for d in ("results", "weights"):
        assert _tree(ROOT / d) == before[d]


@pytest.mark.parametrize("flag,target", [("--save_dir", "results"),
                                         ("--weight_dir", "weights"),
                                         ("--save_dir", "./results/")])
def test_jax_directories_are_refused(flag, target):
    with pytest.raises(SystemExit, match="JAX package"):
        demos.demo_argv("vivit", [flag, target if target.startswith(".")
                                  else str(ROOT / target)])


def test_aggregate_results_parses_the_port_report(vivit_demo):
    _, out, _ = vivit_demo
    agg = _script_module(ROOT / "analysis/aggregate_results.py")
    df = agg.main(["--results_dir", str(out / "r"), "--out", str(out / "summary.csv")])
    assert df is not None and list(df.tag) == ["demo_vivit"]
    row = df.iloc[0]
    assert 0.0 <= row["macro F1"] <= 1.0 and row["threshold"] == 0.5
    assert np.isfinite(row["valid_f1_final"])


def test_eda_prints_jax_lines(capsys, tmp_path):
    jax_eda = _script_module(ROOT / "analysis/eda.py")
    jax_eda.main(["--synthetic", "--save_dir", str(tmp_path / "jax")])
    want = [ln for ln in capsys.readouterr().out.splitlines() if not ln.startswith("wrote")]
    res = eda.main(["--synthetic", "--save_dir", str(tmp_path / "port")])
    got = [ln for ln in capsys.readouterr().out.splitlines() if not ln.startswith("wrote")]
    assert got == want and len(got) == 1 + len(eda.DISTS)
    assert len(res["disruptive_fraction"]) == len(eda.DISTS)
    assert (tmp_path / "port" / "eda.png").exists()


def test_xai_demo_runs_small_on_the_cpu(tmp_path):
    res = xai_demo.main(["--synthetic", "--device", "cpu", "--image_size", "32",
                         "--seq_len", "4", "--save_dir", str(tmp_path)])
    assert res["gradcam"].shape[0] == 1 and np.isfinite(res["gradcam"]).all()
    assert res["space"].shape[:2] == (1, 4) and np.isfinite(res["space"]).all()
    assert res["temporal"].shape == (1, 4) and np.isfinite(res["temporal"]).all()
    assert (tmp_path / f"xai_shot_{res['shot']}.png").exists()
