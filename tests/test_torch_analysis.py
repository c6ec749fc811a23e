"""The port's analysis package against the reference's: reprolint rule by
rule (a trigger and a clean source each; the rules both packages share
give the reference's findings on the same source, and the port's tree
lints clean under the port's rules), the lint CLI, docsmoke on the
reference's own fixtures (equal results), planlint's CLI on temporary
modules of pipelines, and ``core.shuffle``'s façade."""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import docsmoke as ref_docsmoke
from repro.analysis import planlint as ref_planlint
from repro.analysis import reprolint as ref_reprolint
from repro.core import shuffle as ref_shuffle
from repro.engine import stages as ref_stages
from repro_torch.analysis import docsmoke, planlint, reprolint
from repro_torch.analysis.lint import main as lint_main
from repro_torch.core import shuffle
from repro_torch.engine import stages
from repro_torch.engine.compile import SimulatedAxis

REPO = pathlib.Path(__file__).resolve().parent.parent
PATH = "src/repro_torch/streaming/foo.py"
KPATH = "src/repro_torch/kernels/foo.py"


def _lint(src, path=PATH, lint=reprolint.lint_source):
    return lint(textwrap.dedent(src), path)


def _found(findings):
    return [(d.rule_id, d.line) for d in findings]


_LANE_MODULE = """\
import numpy as np
import torch
from repro_torch.analysis.lanes import lane

LANE_DEVICE_STATE = {{"carry", "stats"}}


class C:
    @lane("{lane}")
    def f(self, stats, rows):
        {body}
"""

_SHARED_MODULE = """\
from repro_torch.analysis.lanes import lane

LANE_SHARED = {{"_pending_stats": ("driver", "barrier"),
               "tables": ("driver",)}}


class C:
    @lane("{lane}")
    def f(self, x):
        {body}
"""

_IMPURE = """\
import numpy as np
_n = 0

def body(x, stats):
    global _n
    print(x)
    if x.any():
        return np.asarray(stats)
    return x
"""

#: (case, source, path): sources on which the shared rules must give the
#: reference's findings, triggers and clean ones
SHARED = [
    ("rl102_item", _LANE_MODULE.format(lane="driver",
                                       body="return rows.item()"), PATH),
    ("rl102_int_over_state", _LANE_MODULE.format(
        lane="prefetch", body="return int(stats[0])"), PATH),
    ("rl102_asarray_of_state", _LANE_MODULE.format(
        lane="driver", body="return np.asarray(stats)"), PATH),
    ("rl102_barrier_clean", _LANE_MODULE.format(
        lane="barrier", body="return rows.item()"), PATH),
    ("rl102_local_int_clean", _LANE_MODULE.format(
        lane="driver", body="n = len(rows); return int(n)"), PATH),
    ("rl103_append_off_lane", _SHARED_MODULE.format(
        lane="prefetch", body="self._pending_stats.append(x)"), PATH),
    ("rl103_assign_off_lane", _SHARED_MODULE.format(
        lane="prefetch", body="self._pending_stats = []"), PATH),
    ("rl103_method_off_lane", _SHARED_MODULE.format(
        lane="barrier", body="self.tables[0].load_state_dict(x)"), PATH),
    ("rl103_declared_lane_clean", _SHARED_MODULE.format(
        lane="driver", body="self._pending_stats.append(x)"), PATH),
    ("rl104_impure_kernel", _IMPURE, KPATH),
    ("rl104_impure_stages", _IMPURE, "src/repro_torch/engine/stages.py"),
    ("rl104_elsewhere_clean", _IMPURE, PATH),
    ("rl104_static_branch_clean", """\
def body(x, hashed):
    if hashed:
        return x.sum()
    while x.shape[0] > 1:
        x = x[:1]
    return x
""", KPATH),
    ("rl106_function", '__all__ = ["f"]\n\ndef f():\n    return 1\n', PATH),
    ("rl106_class", '__all__ = ["C"]\n\nclass C:\n    x = 1\n', PATH),
    ("rl106_documented_clean",
     '__all__ = ["f"]\n\ndef f():\n    "Docs."\n    return 1\n', PATH),
    ("rl106_reexport_clean",
     'from os.path import join\n__all__ = ["join"]\n', PATH),
    ("suppressed_line", _LANE_MODULE.format(
        lane="driver", body="return rows.item()  # reprolint: "
                            "disable=RL102"), PATH),
    ("suppressed_file", "# reprolint: disable-file=RL104\n" + _IMPURE,
     KPATH),
]


@pytest.mark.parametrize("case,src,path", SHARED, ids=[c[0] for c in SHARED])
def test_shared_rules_match_reference(case, src, path):
    got = _found(_lint(src, path))
    want = _found(_lint(src, path.replace("repro_torch", "repro"),
                        ref_reprolint.lint_source))
    assert got == want
    assert (got == []) == (case.endswith("clean")
                           or case.startswith("suppressed"))
    assert all(rule.lower() in case for rule, _ in got)


@pytest.mark.parametrize("src,line", [
    ("import torch.distributed as dist\n", 1),
    ("from torch.distributed import all_reduce\n", 1),
    ("from torch import distributed\n", 1),
    ("import torch\n\ndef f(x):\n    torch.distributed.all_reduce(x)\n", 4),
])
def test_rl101_collectives_outside_compile(src, line):
    (d,) = _lint(src)
    assert (d.rule_id, d.line) == ("RL101", line)
    assert "DistributedAxis" in d.message
    assert _lint(src, "src/repro_torch/engine/compile.py") == []


def test_rl101_clean_sources():
    assert _lint("import torch\nimport torch.nn.functional as F\n") == []
    assert _lint("backend = 'shard_map'\ndist = None\n") == []
    assert _lint("def f(axis, x):\n    return axis.psum(x)\n") == []


@pytest.mark.parametrize("body,what", [
    ("return rows.cpu()", ".cpu()"),
    ("return rows.tolist()", ".tolist()"),
    ("return rows.numpy()", ".numpy()"),
    ("torch.cuda.synchronize()", "torch.cuda.synchronize"),
    ("return float(stats.sum())", "float() over device state"),
])
def test_rl102_torch_host_syncs(body, what):
    for lane_name in ("driver", "prefetch"):
        (d,) = _lint(_LANE_MODULE.format(lane=lane_name, body=body))
        assert d.rule_id == "RL102" and what in d.message
    assert _lint(_LANE_MODULE.format(lane="barrier", body=body)) == []
    # a stage or kernel body may not sync either (it declares no device
    # state: there every tensor is on the card)
    if "stats" not in body:
        (d,) = _lint(f"import torch\n\ndef f(rows):\n    {body}\n", KPATH)
        assert d.rule_id == "RL104" and what in d.message


def test_rl102_clean_sources():
    for body in ("return rows.to('cuda', non_blocking=True)",
                 "return np.asarray(rows)",
                 "return torch.as_tensor(rows)"):
        assert _lint(_LANE_MODULE.format(lane="driver", body=body)) == []


def test_rl104_torch_reductions():
    (d,) = _lint("import torch\n\ndef f(x):\n    if torch.any(x):\n"
                 "        return x\n    return -x\n", KPATH)
    assert d.rule_id == "RL104" and "torch.any" in d.message
    assert _lint("import torch\n\ndef f(x):\n"
                 "    return torch.where(x.any(), x, -x)\n", KPATH) == []


def test_rule_table_and_rl105():
    """Every reference rule but RL105 has a port rule of the same id;
    RL105 (donation) has no object in the port, and its docstring says
    so."""
    assert set(ref_reprolint.RULES) - set(reprolint.RULES) == {"RL105"}
    assert set(reprolint.RULES) <= set(ref_reprolint.RULES)
    assert "RL105" in reprolint.__doc__ and "donat" in reprolint.__doc__
    donates = [f for f in reprolint.iter_python_files([REPO / "src" /
                                                       "repro_torch"])
               if any(isinstance(n, ast.keyword) and n.arg == "donate"
                      for n in ast.walk(ast.parse(f.read_text())))]
    assert donates == []


def test_allowlist_and_suppressions_as_the_reference(tmp_path):
    bad = tmp_path / "legacy" / "old.py"
    bad.parent.mkdir()
    bad.write_text("import torch.distributed as dist\n")
    assert _found(reprolint.lint_paths([tmp_path])) == [("RL101", 1)]
    allow = tmp_path / ".reprolint-allow"
    allow.write_text("# reviewed exception\n*legacy/*::RL101\n")
    assert reprolint.lint_paths([tmp_path],
                                reprolint.load_allowlist(allow)) == []
    allow.write_text("*legacy/*::RL102\n")
    assert _found(reprolint.lint_paths(
        [tmp_path], reprolint.load_allowlist(allow))) == [("RL101", 1)]
    assert reprolint.load_allowlist(allow) == \
        ref_reprolint.load_allowlist(allow)
    (bad.parent / "broken.py").write_text("def (:\n")
    assert [d.rule_id for d in reprolint.lint_paths([tmp_path])] == \
        ["RL000", "RL101"]


def test_the_port_lints_clean():
    allow = reprolint.load_allowlist(REPO / ".reprolint-allow")
    findings = reprolint.lint_paths([REPO / "src" / "repro_torch"], allow)
    assert findings == [], "\n".join(d.format() for d in findings)


def test_lint_cli_exit_codes(tmp_path, capsys, monkeypatch):
    assert lint_main(["--list-rules"]) == 0
    assert "RL101" in capsys.readouterr().out
    good = tmp_path / "ok.py"
    good.write_text("x = 1\n")
    assert lint_main([str(good)]) == 0
    bad = tmp_path / "bad.py"
    bad.write_text("from torch import distributed\n")
    assert lint_main([str(bad)]) == 1
    assert "RL101" in capsys.readouterr().out
    allow = tmp_path / "allow"
    allow.write_text("*bad.py::RL101\n")
    assert lint_main(["--allowlist", str(allow), str(bad)]) == 0
    # from the repository root: the default path and .reprolint-allow
    monkeypatch.chdir(REPO)
    assert lint_main([]) == 0
    assert "0 finding(s)" in capsys.readouterr().out


# -- docsmoke -------------------------------------------------------------------

_DOCS = {
    "fences.md": "# T\n\n```python\nx = 1\n```\n\n```bash\necho no\n```\n"
                 "\n```\nprose\n```\n\n```python\ny = x + 1\n```\n",
    "skip.md": "<!-- docsmoke: skip -->\n```python\nraise RuntimeError()\n"
               "```\n\n```python\nok = True\n```\n",
    "shared.md": "```python\nacc = [1]\n```\nlater prose\n```python\n"
                 "acc.append(2)\nassert acc == [1, 2]\n```\n",
    "bad.md": "line1\n\n```python\nboom()\n```\n",
    "none.md": "no snippets here\n",
}


def test_docsmoke_equals_reference_on_its_fixtures(tmp_path, capsys):
    for name, text in _DOCS.items():
        (tmp_path / name).write_text(text)
        assert docsmoke.extract_snippets(text, name) == [
            docsmoke.Snippet(s.path, s.line, s.source)
            for s in ref_docsmoke.extract_snippets(text, name)]
        got = docsmoke.run_file(tmp_path / name)
        want = ref_docsmoke.run_file(tmp_path / name)
        assert [r.splitlines()[0] for r in got] == \
            [r.splitlines()[0] for r in want]
    n, failures = docsmoke.run_paths([tmp_path])
    ref_n, ref_failures = ref_docsmoke.run_paths([tmp_path])
    assert (n, len(failures)) == (ref_n, len(ref_failures)) == (5, 1)
    assert "NameError" in failures[0]
    assert docsmoke.main([str(tmp_path)]) == ref_docsmoke.main(
        [str(tmp_path)]) == 1
    (tmp_path / "bad.md").unlink()
    assert docsmoke.main([str(tmp_path)]) == 0
    assert "4 file(s), 0 failure(s)" in capsys.readouterr().out


def test_docsmoke_runs_the_port_guide():
    n, failures = docsmoke.run_paths([REPO / "docs" / "port.md"])
    assert n == 1 and failures == [], "\n".join(failures)
    assert len(docsmoke.extract_snippets(
        (REPO / "docs" / "port.md").read_text(), "port.md")) >= 3


def test_docsmoke_default_is_the_port_guide_without_the_reference():
    code = ("import sys\n"
            "from repro_torch.analysis.docsmoke import DEFAULT_PATHS, main\n"
            "assert DEFAULT_PATHS == ('docs/port.md',)\n"
            "rc = main([])\n"
            "loaded = sorted(m for m in sys.modules\n"
            "                if m.split('.')[0] in ('jax', 'repro'))\n"
            "assert not loaded, loaded\n"
            "sys.exit(rc)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={**os.environ, "PYTHONPATH": str(REPO / "src")},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "docsmoke: 1 file(s), 0 failure(s)" in out.stdout


# -- planlint's CLI ---------------------------------------------------------------

_PIPELINES = """\
import warnings

from {pkg}.pipeline import Pipeline, Windowing


def _build(sink, job_id):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (Pipeline.from_source(batch_records=64).key_by()
                .window(Windowing.tumbling(10.0)).reduce("sum").sink(sink)
                .build(job_id=job_id, num_buckets=8, n_workers=4, {extra}))


def build_pipelines():
    return {{"clean": _build("out/", "a"),
             "reserved": _build("jobs/out/", "b")}}
"""


def _cli_lines(out, root):
    return [line.replace(str(root), "<root>") for line in out.splitlines()]


def test_planlint_cli_on_a_temporary_module(tmp_path, capsys, monkeypatch):
    """The port's CLI on a module of port pipelines prints what the
    reference's prints on the same module built with its own pipelines,
    and exits 1 for the error-level PL005 finding; a module without
    ``build_pipelines()`` is skipped; a clean one exits 0.  With no path
    it checks the port's examples (``examples_torch``), as the
    reference's checks its ``examples``."""
    for pkg, extra in (("repro_torch", 'device="cpu"'),
                       ("repro", 'backend="pallas"')):
        d = tmp_path / pkg
        d.mkdir()
        (d / "jobs.py").write_text(_PIPELINES.format(pkg=pkg, extra=extra))
        (d / "other.py").write_text("x = 1\n")
    assert planlint.main([str(tmp_path / "repro_torch")]) == 1
    got = _cli_lines(capsys.readouterr().out, tmp_path / "repro_torch")
    assert ref_planlint.main([str(tmp_path / "repro")]) == 1
    want = _cli_lines(capsys.readouterr().out, tmp_path / "repro")
    assert got == want
    assert "<root>/jobs.py:clean: clean" in got
    assert "<root>/other.py: skipped (no build_pipelines())" in got
    assert any("PL005" in line for line in got)
    assert got[-1] == "planlint: 2 program(s) checked, 1 error(s)"
    clean = tmp_path / "clean.py"
    clean.write_text(_PIPELINES.format(pkg="repro_torch",
                                       extra='device="cpu"')
                     .replace('"jobs/out/"', '"more/"'))
    assert planlint.main([str(clean)]) == 0
    capsys.readouterr()
    monkeypatch.chdir(tmp_path)
    (tmp_path / "examples_torch").mkdir()
    (tmp_path / "examples_torch" / "jobs.py").write_text(
        _PIPELINES.format(pkg="repro_torch", extra='device="cpu"'))
    assert planlint.main([]) == 1
    assert "examples_torch/jobs.py:clean: clean" in \
        capsys.readouterr().out.splitlines()


# -- core.shuffle -------------------------------------------------------------------

def test_shuffle_facade_reexports_engine_stages():
    assert shuffle.__all__ == ref_shuffle.__all__
    for name in shuffle.__all__:
        assert getattr(shuffle, name) is getattr(stages, name), name
        assert hasattr(ref_stages, name)


@pytest.mark.parametrize("workers,n_slots,buckets", [(1, 3, 8), (4, 2, 16)])
def test_shuffle_aggregate_windowed_matches_reference(workers, n_slots,
                                                      buckets):
    """Each worker's slice of the (slot, bucket) sums, against the
    reference's under ``jax.vmap`` over a worker axis, integer-valued so
    the sums are exact; invalid rows and keys past the bucket space are
    dropped in both."""
    rng = np.random.default_rng(workers)
    n = 50
    slots = rng.integers(0, n_slots, (workers, n)).astype(np.int32)
    keys = rng.integers(0, buckets, (workers, n)).astype(np.int32)
    vals = rng.integers(0, 9, (workers, n, 2)).astype(np.float32)
    valid = rng.random((workers, n)) < 0.8
    want = jax.vmap(
        lambda s, k, v, m: ref_stages.shuffle_aggregate_windowed(
            s, k, v, "w", n_slots, buckets, valid=m),
        axis_name="w")(jnp.asarray(slots), jnp.asarray(keys),
                       jnp.asarray(vals), jnp.asarray(valid))
    got = shuffle.shuffle_aggregate_windowed(
        torch.from_numpy(slots.reshape(-1)),
        torch.from_numpy(keys.reshape(-1)),
        torch.from_numpy(vals.reshape(-1, 2)), SimulatedAxis(workers),
        n_slots, buckets, valid=torch.from_numpy(valid.reshape(-1)))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
