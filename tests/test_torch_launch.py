"""The port's training launcher (``python -m repro_torch.launch.train``)
against the JAX package's ``repro.launch.train``.

- ``main([..., "--device", "cpu"])`` on reduced smollm-360m for the
  monolithic ``sim`` path (with ``--checkpoint``), ``inproc``,
  ``multiproc`` and ``--vertical off``: exit 0, and the JSON summary has
  the keys the reference's ``main`` writes on the same path.
- The ``runtime`` report equals the reference's ``_runtime_report``
  exactly, schedule by schedule.
- Bad argvs (the compat pairs, the ranges, ``--checkpoint`` with split
  execution, a centralized run with split flags) exit with the
  reference's own ``SystemExit`` text; the configs the port does not
  carry yet exit naming their ROADMAP.md Queue 1 item.
- The wire-overlay flags (``--compress``, ``--secure-agg``,
  ``--agg-tree-fanout``) each train a reduced step to exit 0.
- ``compat.CLI_NAMES`` and ``cli_reject`` equal the reference's.
- The new modules import with jax, the JAX package and ``msgpack``
  blocked.
"""
import ast
import json
import os
import subprocess
import sys
from argparse import Namespace
from pathlib import Path

import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.core import compat as jax_compat
from repro.launch import train as jax_launch
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs.base import get_arch
from repro_torch.core import compat
from repro_torch.launch import train as launch
from repro_torch.models import backbone
from repro_torch.tree_util import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--arch", "smollm-360m", "--reduced", "--steps", "3", "--batch",
         "4", "--seq", "16"]
# the keys repro.launch.train.main puts in its summary, by path: the
# metrics' summary, then the launcher's own
METRIC_KEYS = {"first_loss", "last_loss", "best_loss", "mean_step_s",
               "loss_drop"}
MONO_KEYS = METRIC_KEYS | {"arch", "params", "steps", "vertical"}
SPLIT_KEYS = MONO_KEYS | {"transport", "inflight_steps", "secure_agg",
                          "compress", "agg_tree_fanout", "runtime"}
SPLIT_RUNTIME_KEYS = {"mode", "transport", "step_time_s", "staleness",
                      "deadline_misses", "cut_bytes_per_client"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread_each():
    """One intra-op thread here and in every spawned child: the suite
    runs in parallel worker processes."""
    before, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(before)
    if env is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = env


@pytest.mark.parametrize("extra", [
    ["--transport", "sim", "--checkpoint"], ["--transport", "inproc"],
    ["--transport", "multiproc"], ["--vertical", "off"]],
    ids=["sim", "inproc", "multiproc", "centralized"])
def test_main_runs_each_path(tmp_path, capsys, extra):
    """Each path trains 3 steps on the CPU and writes the reference's
    summary keys; the sim path's checkpoint holds the trained params."""
    ckpt = str(tmp_path / "ckpt.msgpack")
    if extra[-1] == "--checkpoint":
        extra = extra + [ckpt]
    out = str(tmp_path / "run.json")
    assert launch.main(SMALL + extra + ["--device", "cpu", "--json",
                                        out]) == 0
    printed = capsys.readouterr().out
    with open(out) as f:
        run = json.load(f)
    summary, losses = run["summary"], run["losses"]
    assert len(losses) == 3 and all(l == l for l in losses)
    cfg = get_arch("smollm-360m").reduced()
    if "--vertical" in extra:
        assert set(summary) == MONO_KEYS and summary["vertical"] == "off"
        cfg = cfg.with_vertical(None)
    elif "sim" in extra:
        assert set(summary) == MONO_KEYS | {"runtime"}
        tree, step = load_checkpoint(ckpt)
        assert step == 3 and "towers" in tree
        assert sum(t.numel() for t in tree_leaves(tree)) == \
            summary["params"]
    else:
        assert set(summary) == SPLIT_KEYS
        assert set(summary["runtime"]) == SPLIT_RUNTIME_KEYS
        assert summary["runtime"]["transport"] == extra[1]
        assert "step-0 verification vs protocol_step" in printed
    assert summary["params"] == backbone.param_count(cfg)
    assert summary["first_loss"] == losses[0]


def _args(**kw) -> Namespace:
    base = dict(runtime="serial", microbatches=4, inflight_steps=1,
                straggler=None, batch=8, seq=256)
    return Namespace(**{**base, **kw})


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-1.3b"])
def test_runtime_report_equals_jax(capsys, arch):
    """Pure simulation on the host: every schedule's report and its
    printed line are the reference's, key for key and float for float."""
    cases = [_args(), _args(runtime="pipelined"),
             _args(runtime="nowait", straggler=1),
             _args(inflight_steps=2), _args(runtime="pipelined",
                                            microbatches=2, inflight_steps=3,
                                            batch=4, seq=64)]
    for reduced in (False, True):
        cfg, jcfg = get_arch(arch), jax_get_arch(arch)
        if reduced:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        for args in cases:
            if args.straggler is not None and \
                    args.straggler >= cfg.vertical.num_clients:
                continue
            mine = launch._runtime_report(cfg, args)
            mine_line = capsys.readouterr().out
            theirs = jax_launch._runtime_report(jcfg, args)
            assert mine == theirs
            assert mine_line == capsys.readouterr().out


BAD_ARGVS = [
    # the compat matrix at the launch layer
    ["--secure-agg", "--compress", "topk"],
    ["--secure-agg", "--runtime", "nowait"],
    ["--agg-tree-fanout", "2", "--merge", "max"],
    ["--agg-tree-fanout", "2", "--runtime", "nowait"],
    ["--agg-tree-fanout", "2", "--compress", "int8"],
    # the overlays' own checks
    ["--compress", "topk", "--topk-fraction", "0"],
    ["--compress", "int8", "--topk-fraction", "1.5"],
    ["--secure-agg"],
    ["--secure-agg", "--transport", "inproc", "--merge", "max"],
    ["--agg-tree-fanout", "2"],
    ["--agg-tree-fanout", "1", "--transport", "inproc"],
    ["--vertical", "off", "--secure-agg"],
    ["--vertical", "off", "--compress", "int8"],
    # centralized runs with split-execution flags
    ["--vertical", "off", "--transport", "inproc"],
    ["--vertical", "off", "--runtime", "pipelined"],
    ["--vertical", "off", "--straggler", "0"],
    # ranges and split execution
    ["--microbatches", "0"],
    ["--inflight-steps", "0"],
    ["--runtime", "pipelined", "--batch", "6", "--microbatches", "4"],
    ["--straggler", "2", "--reduced"],
    ["--straggler", "-1"],
    ["--transport", "inproc", "--checkpoint", "ckpt.msgpack"],
    ["--transport", "multiproc", "--checkpoint", "ckpt.msgpack"],
    ["--scale", "10m", "--microbatches", "-3"],
]


@pytest.mark.parametrize("argv", BAD_ARGVS,
                         ids=[" ".join(a) for a in BAD_ARGVS])
def test_bad_argv_exits_with_the_reference_text(argv):
    """Rejected before any training, with the reference's words."""
    with pytest.raises(SystemExit) as theirs:
        jax_launch.main(argv)
    with pytest.raises(SystemExit) as mine:
        launch.main(argv + ["--device", "cpu"])
    assert isinstance(mine.value.code, str)
    assert mine.value.code == theirs.value.code


@pytest.mark.parametrize("argv", [
    ["--compress", "topk", "--transport", "inproc"],
    ["--secure-agg", "--transport", "multiproc"],
    ["--agg-tree-fanout", "2", "--transport", "inproc"]],
    ids=["compress", "secure-agg", "agg-tree-fanout"])
def test_overlay_flags_run(tmp_path, capsys, argv):
    """Each wire overlay's flag trains one reduced step to exit 0, verified
    at step 0 in-run, with the reference's summary keys."""
    out = str(tmp_path / "run.json")
    assert launch.main(argv + ["--reduced", "--steps", "1", "--batch", "4",
                               "--seq", "16", "--device", "cpu", "--json",
                               out]) == 0
    printed = capsys.readouterr().out
    assert "verification vs protocol_step" in printed
    with open(out) as f:
        summary = json.load(f)["summary"]
    assert set(summary) == SPLIT_KEYS
    assert summary["transport"] == argv[-1]


@pytest.mark.parametrize("argv,item", [
    (["--arch", "zamba2-7b", "--reduced"], "item 11"),
    (["--arch", "stablelm-3b"], "item 12"),
    (["--arch", "deepseek-moe-16b", "--transport", "inproc"], "item 13"),
    (["--arch", "whisper-tiny"], "item 13"),
    (["--arch", "internvl2-26b", "--vertical", "off"], "item 13"),
])
def test_unported_exits_naming_its_item(argv, item):
    """What the port does not carry yet never runs without it: the exit
    names the config and its ROADMAP.md Queue 1 item."""
    with pytest.raises(SystemExit) as e:
        launch.main(argv + ["--device", "cpu"])
    text = e.value.code
    assert isinstance(text, str) and "not ported" in text
    assert f"Queue 1, {item})" in text and argv[0] in text


def test_card_by_default():
    """Without ``--device`` the launcher runs on the card, and without one
    it exits saying so (no fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is honoured there")
    with pytest.raises(SystemExit, match="--device cuda: .*no CUDA device"):
        launch.main(SMALL)


def test_cli_names_and_reject_equal_jax():
    """The flag names, and the rejection text of every rule enforced at
    the launch layer, as the reference phrases them."""
    assert compat.CLI_NAMES == jax_compat.CLI_NAMES
    launch_rules = [r for r in jax_compat.RULES if "launch" in r.layers]
    mine = {r.key: r for r in compat.RULES}
    assert launch_rules and all("launch" in mine[r.key].layers
                                for r in launch_rules)
    for rule in launch_rules:
        got = compat.cli_reject(compat.CompatError(mine[rule.key], "launch"))
        want = jax_compat.cli_reject(jax_compat.CompatError(rule, "launch"))
        assert isinstance(got, SystemExit) and got.code == want.code


def _imports(path: Path) -> list:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_new_modules_import_neither_jax_repro_nor_msgpack():
    """The launcher, the process transport and the checkpoint modules
    import torch and numpy only: by AST over the whole port, and by
    importing them with jax, the JAX package and msgpack blocked."""
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "repro", "msgpack"), \
                (path, name)
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; sys.modules['msgpack'] = None; "
            "import repro_torch.launch.train, repro_torch.checkpoint, "
            "repro_torch.transport.multiproc, repro_torch.train.loop; "
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
