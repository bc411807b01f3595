"""The port's repro-lint (`repro_torch.analysis`) against the JAX package's
(`repro.analysis`).

Where a rule's contract is shared (RL000, RL002's branch and key parts,
RL003, RL004, RL005's print/env/file checks, RL006's obs names) both
linters must give the same ``(line, code)`` list on the same source: on
fixture snippets and on faults planted in copies of the port's own files.
Where the port's rule is written for torch (RL001, RL005's build ban,
RL006's `repro_torch.obs` and torch timing calls) or drops a JAX-only
part (RL002's jit closures), the cases show the two diverge. Both linters
are stdlib-only; nothing here imports torch or jax (tests/conftest.py
does, for the suite).
"""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

import repro.analysis as jax_lint
import repro_torch.analysis as port_lint
from repro_torch.analysis.rules.rl006_obs import OBS_NAMES

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
KERNEL_PATH = "src/repro_torch/kernels/svrg_update/kernel.py"
HELPER_PATH = "src/repro_torch/core/helper.py"


def lines(diags):
    return [(d.line, d.code) for d in diags]


def both(source, path="<memory>"):
    """(JAX linter's, port linter's) ``(line, code)`` lists."""
    return (lines(jax_lint.lint_source(source, path=path)),
            lines(port_lint.lint_source(source, path=path)))


# ------------------------------------------------------ shared: RL000 hygiene
NUMPY_AXISLESS = """\
import numpy as np

def sample_grad_stable(x, w):
    return np.sum(x * w)
"""

RL000_CASES = {
    "reasoned_ignore_silences": (NUMPY_AXISLESS.replace(
        "np.sum(x * w)",
        "np.sum(x * w)  # repro-lint: ignore[RL001] x, w are 1-D here"), []),
    "reasonless_ignore": (NUMPY_AXISLESS.replace(
        "np.sum(x * w)", "np.sum(x * w)  # repro-lint: ignore[RL001]"),
        [(4, "RL000")]),
    "stale_ignore": ("X = 1  # repro-lint: ignore[RL001] nothing here\n",
                     [(1, "RL000")]),
    "unknown_code": ("X = 1  # repro-lint: ignore[RL999] bogus code\n",
                     [(1, "RL000")]),
    "hash_in_string": ('MSG = "use # repro-lint: ignore[RL001] sparingly"\n',
                       []),
    "unsuppressed": (NUMPY_AXISLESS, [(4, "RL001")]),
}

# --------------------------------------------- shared: RL002 parts 2 and 3
RL002_CASES = {
    "if_on_tensor_param": ("""\
def _epoch_core(w, eta, *, drop_prob):
    if eta > 0:
        w = w * eta
    return w
""", [(2, "RL002")]),
    "while_on_tensor_param": ("""\
def _hogwild_epochs_core(obj, data, w0, key, *, epochs):
    while w0.abs().max() > 1:
        w0 = w0 / 2
    return w0
""", [(2, "RL002")]),
    "unhashable_key": ("""\
class Obj:
    def runner_static_key(self):
        return [self.n, self.p]

def runner_key(engine, *, total):
    return (engine, sorted({total}))
""", [(3, "RL002"), (6, "RL002")]),
    "statics_and_probes_clean": ("""\
def _asysvrg_epochs_core(obj, data, w0, key, *, epochs, drop_prob):
    if drop_prob > 0:          # kw-only param: static by convention
        w0 = w0 * 2
    if w0.ndim == 2 and len(key) and isinstance(data, tuple):
        w0 = w0[0]
    return w0

class Obj:
    def static_key(self):
        return (self.n, tuple(sorted(self.names)), frozenset(self.tags))
""", []),
}

# ------------------------------------------------------- shared: RL003 locks
RL003_CASES = {
    "unlocked_access": ("""\
import threading

class Daemon:
    def __init__(self):
        self._lock = threading.Lock()
        self.stats = 0  # guarded-by: _lock

    def bump(self):
        self.stats += 1
""", [(9, "RL003")]),
    "lock_condition_alias_and_holds": ("""\
import threading

class Daemon:
    _GUARDED_BY = {"_queue": "_lock"}

    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self.stats = 0  # guarded-by: _lock
        self._queue = []

    def bump(self):
        with self._lock:
            self.stats += 1

    def drain(self):
        with self._cv:             # Condition(self._lock) aliases _lock
            self._queue.clear()

    def _bump_locked(self):  # holds: _lock
        self.stats += 1
""", []),
    "class_map_unlocked": ("""\
class Service:
    _GUARDED_BY = {"_pending": "_lock"}

    def pending(self):
        return len(self._pending)
""", [(5, "RL003")]),
    "escaped_closure": ("""\
import threading

class Daemon:
    def __init__(self):
        self._lock = threading.Lock()
        self.stats = 0  # guarded-by: _lock

    def make_bumper(self):
        with self._lock:
            def bump():            # closure outlives the with-block
                self.stats += 1
            return bump
""", [(11, "RL003")]),
}

# -------------------------------------------------------- shared: RL004 keys
RL004_SWEEP = """\
from typing import NamedTuple

class _Resolved(NamedTuple):
    engine: str
    buf_len: int
    tau: int

def plan_sweep(resolved):
    groups = {}
    for c, r in enumerate(resolved):
        groups.setdefault((r.engine, r.buf_len), []).append(c)
    return groups

def _dispatch_group(resolved, members):
    return [resolved[c].tau for c in members]
"""

RL004_CASES = {
    "keyed_and_packed_clean": (RL004_SWEEP, []),
    "unkeyed_field": (RL004_SWEEP.replace("(r.engine, r.buf_len)",
                                          "(r.engine,)"), [(5, "RL004")]),
    "no_key_anchor": (RL004_SWEEP.replace(
        "groups.setdefault((r.engine, r.buf_len), []).append(c)",
        "groups[c] = r"), [(8, "RL004")]),
    "key_param_never_read": ("""\
def runner_key(engine, *, total, buf_len):
    return (engine, total)

def get_group_runner(engine, *, total, buf_len):
    key = runner_key(engine, total=total, buf_len=buf_len)
    return key
""", [(1, "RL004")]),
    "param_not_forwarded": ("""\
def runner_key(engine, *, total):
    return (engine, total)

def get_group_runner(engine, *, total, fused):
    key = runner_key(engine, total=total)
    return key, fused
""", [(5, "RL004")]),
}

# --------------------------------------- shared: RL005 print / env / file I/O
KERNEL_IMPURE = """\
import os

def launch(u, out):
    print("launching")
    mode = os.environ.get("REPRO_KERNEL_MODE")
    level = os.getenv("LEVEL")
    with open("/dev/null") as fh:
        fh.write(mode)
    breakpoint()
    return 0
"""

RL005_CASES = {
    "kernel_module": (KERNEL_IMPURE, KERNEL_PATH,
                      [(4, "RL005"), (5, "RL005"), (6, "RL005"),
                       (7, "RL005"), (9, "RL005")]),
    "outside_kernels": (KERNEL_IMPURE, HELPER_PATH, []),
}

# ------------------------------------------------ shared: RL006's obs names
RL006_CASES = {
    "obs_calls_in_core": ("""\
import time

def epoch_core(w, key):
    t0 = time.perf_counter()
    tr = tracer()
    tr.annotate(started=t0)
    return w
""", "<memory>", [(4, "RL006"), (5, "RL006"), (6, "RL006")]),
    "live_obs_in_core": ("""\
def _epoch_core(w, hist):
    bus = progress_bus()
    bus.publish(kind="slice")
    enforce_group(wd, hist, w)
    led = ledger()
    led.record_dispatch(key=k)
    return w
""", "<memory>", [(2, "RL006"), (3, "RL006"), (4, "RL006"),
                  (5, "RL006"), (6, "RL006")]),
    "kernel_module_wholesale": ("""\
import time

def launch(u, out):
    t0 = time.monotonic_ns()
    hist.observe(t0)
    return obs.trace.tracer
""", KERNEL_PATH, [(4, "RL006"), (5, "RL006"), (6, "RL006"),
                   (6, "RL006")]),
    "same_code_outside": ("""\
import time

def launch(u, out):
    t0 = time.monotonic_ns()
    hist.observe(t0)
    return obs.trace.tracer
""", HELPER_PATH, []),
    "brackets_at_dispatch_site": ("""\
import time

def dispatch_group(runner, args):
    t0 = time.perf_counter()
    with tracer().span_active("execute"):
        out = runner(*args)
    hist.observe(time.perf_counter() - t0)
    return out
""", "<memory>", []),
}

SHARED = (
    [pytest.param(src, "<memory>", want, id=f"RL000-{k}")
     for k, (src, want) in RL000_CASES.items()]
    + [pytest.param(src, "<memory>", want, id=f"RL002-{k}")
       for k, (src, want) in RL002_CASES.items()]
    + [pytest.param(src, "<memory>", want, id=f"RL003-{k}")
       for k, (src, want) in RL003_CASES.items()]
    + [pytest.param(src, "<memory>", want, id=f"RL004-{k}")
       for k, (src, want) in RL004_CASES.items()]
    + [pytest.param(src, path, want, id=f"RL005-{k}")
       for k, (src, path, want) in RL005_CASES.items()]
    + [pytest.param(src, path, want, id=f"RL006-{k}")
       for k, (src, path, want) in RL006_CASES.items()])


@pytest.mark.parametrize("source,path,want", SHARED)
def test_shared_rules_agree_with_the_jax_linter(source, path, want):
    jax_lines, port_lines = both(source, path)
    assert port_lines == jax_lines
    assert port_lines == want


# ---------------------------------- planted faults in copies of port files
def _copy(tmp_path, rel):
    dst = tmp_path / rel
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text((PORT / rel).read_text())
    return dst


def _plant(path, old, new):
    text = path.read_text()
    assert text.count(old) == 1, old
    path.write_text(text.replace(old, new))
    return text[:text.index(old)].count("\n") + 1      # old's first line


def _lint_both(paths):
    paths = [str(p) for p in paths]
    return (lines(jax_lint.lint_paths(paths).diagnostics),
            lines(port_lint.lint_paths(paths).diagnostics))


def _fault_daemon_unlocked(tmp_path):
    """`heartbeat_age_s` reads `_heartbeat` with its lock taken out (the
    block kept, its indentation too)."""
    path = _copy(tmp_path, "server/daemon.py")
    line = _plant(path, """\
        with self._lock:
            if self._heartbeat is None:""", """\
        if True:
            if self._heartbeat is None:""")
    return [path], [(line + 1, "RL003"), (line + 3, "RL003")]


def _fault_sweep_key_field(tmp_path):
    """`option` dropped from `plan_sweep`'s group key: `_Resolved.option`
    reaches neither the key nor the per-row arrays."""
    path = _copy(tmp_path, "core/sweep.py")
    _plant(path, "(ofp, r.engine, r.total, r.option, r.buf_len, r.fused)",
           "(ofp, r.engine, r.total, r.buf_len, r.fused)")
    text = path.read_text().splitlines()
    field = text.index("    option: int          # 0 for hogwild (engine "
                       "has no option switch)") + 1
    return [path], [(field, "RL004")]


def _fault_sweep_suppression(tmp_path):
    """The one suppression of the port's tree removed: both linters
    report the derived field."""
    path = _copy(tmp_path, "core/sweep.py")
    line = _plant(path, "passes_per_epoch: float  # repro-lint: "
                  "ignore[RL004] derived", "passes_per_epoch: float  # derived")
    return [path], [(line, "RL004")]


def _fault_cache_forwarding(tmp_path):
    """`get_group_runner` stops forwarding `total` into `runner_key`; the
    lint run names only core/, so the cache is found as sweep.py's
    sibling on disk."""
    sweep = _copy(tmp_path, "core/sweep.py")
    cache = _copy(tmp_path, "service/cache.py")
    line = _plant(cache, "group_epochs=group_epochs, total=total,",
                  "group_epochs=group_epochs,")
    return [sweep.parent], [(line, "RL004")]


def _fault_kernel_env(tmp_path):
    """An environment read planted in a copied ctypes launcher."""
    path = _copy(tmp_path, "kernels/svrg_update/kernel.py")
    _plant(path, "import ctypes\n", "import ctypes\nimport os\n")
    line = _plant(path, "    d = u.shape[-1]\n",
                  "    d = u.shape[-1]\n    os.environ.get('MODE')\n")
    return [path], [(line + 1, "RL005")]


@pytest.mark.parametrize("plant", [
    _fault_daemon_unlocked, _fault_sweep_key_field, _fault_sweep_suppression,
    _fault_cache_forwarding, _fault_kernel_env])
def test_planted_faults_found_by_both_linters(tmp_path, plant):
    paths, want = plant(tmp_path)
    jax_lines, port_lines = _lint_both(paths)
    assert port_lines == jax_lines == want


# ------------------------------------------- port-only: where the rules part
TORCH_STABLE = """\
import torch
import torch.nn.functional as F

def sample_grad_stable(x, w, a, b):
    s = {}
    return s
"""

RL001_FLAGGED = ["torch.sum(x)", "x.sum()", "torch.matmul(a, b)",
                 "(x * w).mean()", "torch.sum(x, dim=None)", "x.std()",
                 "torch.logsumexp(x)", "a.mm(b)", "torch.bmm(a, b)",
                 "torch.einsum('ij,j->i', a, w)", "F.linear(x, a)",
                 "torch.linalg.vector_norm(x, dim=-1)", "x.norm(dim=-1)",
                 "torch.addmm(x, a, b)", "np.dot(x, w)"]
RL001_CLEAN = ["torch.sum(x * w[..., None, :], dim=-1, dtype=torch.float64)",
               "np.sum(x, axis=-1)", "sum(xs)", "x.sum(-1)",
               "torch.sum(x, -1)", "x.mean(dim=-1)", "torch.logaddexp(x, w)",
               "torch.sigmoid(-x) * w", "math.prod(xs)",
               "torch.where(x > 0, x, w)"]


@pytest.mark.parametrize("expr", RL001_FLAGGED)
def test_rl001_flags_torch_reorders(expr):
    jax_lines, port_lines = both(TORCH_STABLE.replace("{}", expr))
    assert port_lines == [(5, "RL001")]
    if expr in ("torch.sum(x)", "x.sum()", "torch.matmul(a, b)"):
        assert jax_lines == []      # the JAX rule sees jnp/np roots only


@pytest.mark.parametrize("expr", RL001_CLEAN)
def test_rl001_clean_forms(expr):
    assert port_lint.lint_source(TORCH_STABLE.replace("{}", expr)) == []


def test_rl001_scope_and_nesting():
    src = """\
def loss_fixed_order(X, w):
    def inner(v):
        return v.sum()
    return inner(X @ w)

def unstable_helper(X, w):
    return (X @ w).sum()
"""
    assert lines(port_lint.lint_source(src)) == [(3, "RL001"), (4, "RL001")]


def test_rl002_jit_closures_are_the_jax_linters_alone():
    src = """\
import jax

def run_reference(obj, w):
    data = obj.data_args()
    loss_fn = jax.jit(lambda w_: obj.flat_loss(data, w_))
    return loss_fn(w)

@jax.jit
def step(w, eta):
    if eta > 0:
        w = w * eta
    return w
"""
    jax_lines, port_lines = both(src)
    assert jax_lines == [(5, "RL002"), (10, "RL002")]
    assert port_lines == []


@pytest.mark.parametrize("path,want", [
    ("src/repro_torch/kernels/sweep_epoch/kernel.py", [(4, "RL005")] * 3),
    ("src/repro_torch/kernels/sweep_epoch/ops.py", [(4, "RL005")] * 3),
    ("src/repro_torch/kernels/_build.py", []),
    (HELPER_PATH, []),
])
def test_rl005_builds_only_in_build_module(path, want):
    src = """\
import ctypes, subprocess, torch

def load(path):
    subprocess.run(["nvcc", path]); ctypes.CDLL(path); ctypes.cdll.LoadLibrary(path)
"""
    jax_lines, port_lines = both(src, path)
    assert port_lines == want
    assert jax_lines == []


@pytest.mark.parametrize("source,path", [
    ("def launch(u):\n    return repro_torch.obs.trace.tracer\n",
     KERNEL_PATH),
    ("import torch\n\ndef _epoch_core(w, key, *, total):\n"
     "    torch.cuda.synchronize()\n    return w\n", "<memory>"),
    ("import torch\n\ndef _epoch_core(w, key, *, total):\n"
     "    ev = torch.cuda.Event(enable_timing=True)\n    return w\n",
     "<memory>"),
    ("import torch\n\ndef _epoch_core(w, key, *, total):\n"
     "    torch.cuda.nvtx.range_push('epoch')\n    return w\n", "<memory>"),
    ("import torch\n\ndef launch(u):\n"
     "    with torch.profiler.record_function('k'):\n        return u\n",
     KERNEL_PATH),
])
def test_rl006_port_names_are_the_port_linters_alone(source, path):
    jax_lines, port_lines = both(source, path)
    assert port_lines and {c for _, c in port_lines} == {"RL006"}
    assert jax_lines == []


def test_rl006_obs_names_exist_in_the_port():
    defined = set()
    for path in (PORT / "obs").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                defined.add(node.name)
    assert OBS_NAMES <= defined, sorted(OBS_NAMES - defined)


def test_rules_keep_the_jax_codes():
    assert set(port_lint.RULES) == set(jax_lint.RULES)


def test_every_jax_module_has_its_counterpart():
    jax_pkg = REPO / "src" / "repro" / "analysis"
    want = sorted(p.relative_to(jax_pkg) for p in jax_pkg.rglob("*.py"))
    got = sorted(p.relative_to(PORT / "analysis")
                 for p in (PORT / "analysis").rglob("*.py"))
    assert got == want and len(got) == 14


# ------------------------------------------------------------- tree and CLI
@pytest.fixture(scope="module")
def port_tree():
    return port_lint.lint_paths([str(PORT)])


def test_port_tree_is_clean(port_tree):
    assert port_tree.diagnostics == [], "\n".join(
        d.render() for d in port_tree.diagnostics)
    assert len(port_tree.files) > 100     # the walk actually found the tree
    assert port_tree.suppressions == 1    # core/sweep.py's RL004, both's


def test_port_tree_walk_matches_the_jax_linters(port_tree):
    jax_tree = jax_lint.lint_paths([str(PORT)])
    assert [sf.path for sf in port_tree.files] == [
        sf.path for sf in jax_tree.files]
    assert jax_tree.diagnostics == []


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})


def test_cli_exits_zero_on_the_port(tmp_path):
    out = tmp_path / "lint.json"
    proc = _cli("--json-out", str(out))        # default path: src/repro_torch
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(out.read_text())
    assert sorted(payload) == ["diagnostics", "files", "rules",
                               "suppressions"]
    assert payload["diagnostics"] == [] and payload["files"] > 100
    assert set(payload["rules"]) == set(port_lint.RULES)


@pytest.mark.parametrize("args,rc,needle", [
    (["{bad}"], 1, "RL001"),
    (["--select", "RL042", "src/repro_torch"], 2, "unknown rule code"),
    (["src/no_such_dir"], 2, "does not exist"),
])
def test_cli_exit_codes(tmp_path, args, rc, needle):
    bad = tmp_path / "bad.py"
    bad.write_text(TORCH_STABLE.replace("{}", "torch.sum(x)"))
    proc = _cli(*[a.replace("{bad}", str(bad)) for a in args])
    assert proc.returncode == rc, proc.stdout + proc.stderr
    assert needle in proc.stdout + proc.stderr


def test_import_pulls_no_torch_jax_or_repro():
    code = """
import sys
import repro_torch.analysis
from repro_torch.analysis.__main__ import main
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "jax", "jaxlib", "repro"))
import repro_torch
assert "torch" not in sys.modules
from repro_torch import run_sweep, core
assert run_sweep is core.run_sweep and "torch" in sys.modules
print(bad)
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
             "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
