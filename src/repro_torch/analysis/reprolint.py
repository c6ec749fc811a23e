"""reprolint — repo-invariant lint over the port's tree, on stdlib ``ast``.

The partner of ``repro/analysis/reprolint.py``, with its rule ids,
suppression comments and allowlist format, retargeted at what the
invariants guard in the port: the one home of the collectives, the
three-lane scheduler's byte-identity contract (no host syncs in hot lanes,
no shared-state mutation off its declared lane), stage and kernel bodies
free of host syncs and side effects, and a documented public surface.

Rules (stable ids, shared with the reference; all findings are
error-level):

======  ====================================================================
RL101   ``torch.distributed`` imported or referenced outside
        ``engine/compile.py``: every collective goes through its
        ``DistributedAxis`` (``psum``, ``pmax``, ``psum_scatter``,
        ``all_to_all``, ``all_gather``, ``barrier``), which the plans, the
        stage bodies, the lowering, the train step and the gradient
        compression call — the reference's one home of ``shard_map``
RL102   host-sync call inside an ``@lane("driver")`` / ``@lane("prefetch")``
        function: ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
        ``torch.cuda.synchronize``, or ``np.asarray`` / ``int()`` /
        ``float()`` over a name in the module's ``LANE_DEVICE_STATE`` set
        — each waits for the card per call instead of per barrier
RL103   mutation of an attribute declared in the module's ``LANE_SHARED``
        table from a lane outside its allowed set (assignment, augmented
        assignment, or any method call through the attribute)
RL104   impurity in a stage or kernel body file (``engine/stages.py``,
        ``kernels/``): ``print``, ``global`` / ``nonlocal``, RL102's host
        syncs and any ``np.asarray``, or branching (``if`` / ``while``)
        on a tensor reduction (``.any()`` / ``.all()`` / ``torch.any`` /
        ``torch.all``), which in eager PyTorch is a hidden host sync
RL106   exported name without a docstring: a class or function defined in
        the module and listed in its ``__all__`` must carry a docstring
        (re-exports are checked where they are defined)
======  ====================================================================

The reference's RL105 (a donated buffer read after the donating call) has
no object in the port: the port updates its carries in place and donates
no buffer, so no call takes ``donate=``.  The id stays reserved.

Suppressions: trailing ``# reprolint: disable=RL102`` (comma-separated
ids, or bare ``disable`` for all rules) silences that line; ``# reprolint:
disable-file=RL104`` anywhere in the file silences the rule file-wide.
A checked-in allowlist (``.reprolint-allow``: ``glob::RULE`` lines, ``*``
wildcards both sides) records intentional exceptions so the CLI stays
blocking.
"""

from __future__ import annotations

import ast
import fnmatch
import pathlib
import re

from .diagnostics import ERROR, Diagnostic

RULES = {
    "RL101": "torch.distributed import/reference outside engine/compile.py",
    "RL102": "host-sync call in a driver/prefetch lane function",
    "RL103": "LANE_SHARED attribute mutated from an undeclared lane",
    "RL104": "impure construct in a stage or kernel body file",
    "RL106": "name exported in __all__ has no docstring",
}

#: lanes where host syncs are part of the design (RL102 does not apply)
SYNC_OK_LANES = frozenset({"barrier"})

#: tensor methods that copy to the host and so wait for the card
_SYNC_METHODS = ("item", "cpu", "tolist", "numpy")

_DISABLE_RE = re.compile(
    r"#\s*reprolint:\s*disable(?P<scope>-file)?"
    r"(?:\s*=\s*(?P<rules>[A-Za-z0-9_,\s]+))?")

__all__ = ["RULES", "iter_python_files", "lint_file", "lint_paths",
           "lint_source", "load_allowlist"]


def _chain(node) -> str | None:
    """Dotted name for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _lane_of(fn) -> str | None:
    for dec in fn.decorator_list:
        if not (isinstance(dec, ast.Call) and dec.args):
            continue
        name = None
        if isinstance(dec.func, ast.Name):
            name = dec.func.id
        elif isinstance(dec.func, ast.Attribute):
            name = dec.func.attr
        if name == "lane" and isinstance(dec.args[0], ast.Constant):
            return dec.args[0].value
    return None


def _literal_table(tree, name):
    """Module-level ``NAME = <literal>`` (the declared-state convention:
    the tables must be literals so the linter can read them)."""
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == name):
            try:
                return ast.literal_eval(node.value)
            except ValueError:
                return None
    return None


def _flat_targets(node):
    out = []
    stack = (list(node.targets) if isinstance(node, ast.Assign)
             else [node.target])
    while stack:
        t = stack.pop()
        if isinstance(t, (ast.Tuple, ast.List)):
            stack.extend(t.elts)
        else:
            out.append(t)
    return out


def _names_in(node) -> set:
    """Every bare name and attribute name referenced under ``node``."""
    out = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
    return out


def _is_sync_call(node: ast.Call, device_state,
                  body: bool = False) -> str | None:
    """Classify a host-sync call; returns a short description or None.
    In a stage or kernel body file (``body``) every ``np.asarray`` counts:
    what it reads there is a tensor on the card, as in the reference."""
    chain = _chain(node.func)
    if body and chain in ("np.asarray", "numpy.asarray"):
        return chain
    if chain == "torch.cuda.synchronize":
        return chain
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in _SYNC_METHODS:
        return f".{node.func.attr}()"
    touched = set()
    for arg in node.args:
        touched |= _names_in(arg)
    hit = touched & set(device_state)
    if not hit:
        return None
    if chain in ("np.asarray", "numpy.asarray"):
        return f"{chain} over device state {sorted(hit)}"
    if isinstance(node.func, ast.Name) and node.func.id in ("int", "float"):
        return f"{node.func.id}() over device state {sorted(hit)}"
    return None


def _is_distributed(chain: str | None) -> bool:
    return chain is not None and (chain == "torch.distributed"
                                  or chain.startswith("torch.distributed."))


class _Suppressions:
    def __init__(self, src: str):
        self.lines: dict = {}
        self.file_rules: set = set()
        self.file_all = False
        for i, line in enumerate(src.splitlines(), start=1):
            m = _DISABLE_RE.search(line)
            if not m:
                continue
            rules = m.group("rules")
            ids = ({r.strip().upper() for r in rules.split(",") if r.strip()}
                   if rules else None)
            if m.group("scope"):
                if ids is None:
                    self.file_all = True
                else:
                    self.file_rules |= ids
            else:
                self.lines[i] = ids      # None means "all rules"

    def active(self, rule: str, line: int) -> bool:
        if self.file_all or rule in self.file_rules:
            return True
        if line in self.lines:
            ids = self.lines[line]
            return ids is None or rule in ids
        return False


def lint_source(src: str, path: str) -> list:
    """Lint one file's source; returns non-suppressed error Diagnostics."""
    norm = path.replace("\\", "/")
    tree = ast.parse(src, filename=path)
    supp = _Suppressions(src)
    findings: list = []

    def emit(rule, message, node):
        line = getattr(node, "lineno", 0)
        if not supp.active(rule, line):
            findings.append(Diagnostic(rule, ERROR, message,
                                       path=path, line=line))

    is_compile = norm.endswith("engine/compile.py")
    is_body = (norm.endswith("engine/stages.py")
               or "kernels" in norm.split("/")[:-1])
    lane_shared = _literal_table(tree, "LANE_SHARED") or {}
    device_state = _literal_table(tree, "LANE_DEVICE_STATE") or set()

    # ---- RL101: the collectives' one home ---------------------------
    if not is_compile:
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if _is_distributed(alias.name):
                        emit("RL101",
                             f"import {alias.name}: collectives go "
                             f"through engine.compile.DistributedAxis",
                             node)
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if _is_distributed(mod) or (
                        mod == "torch" and any(a.name == "distributed"
                                               for a in node.names)):
                    emit("RL101",
                         f"from {mod} import ...: collectives go through "
                         f"engine.compile.DistributedAxis", node)
            elif isinstance(node, ast.Attribute) and node.attr == \
                    "distributed" and _chain(node) == "torch.distributed":
                emit("RL101",
                     "torch.distributed referenced directly: collectives "
                     "go through engine.compile.DistributedAxis", node)

    # ---- RL106: exported names are documented ------------------------
    exported = _literal_table(tree, "__all__") or ()
    if exported:
        defs = {n.name: n for n in tree.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef))}
        for name in exported:
            node = defs.get(name)
            if node is not None and ast.get_docstring(node) is None:
                emit("RL106",
                     f"{name!r} is exported in __all__ but carries no "
                     f"docstring — the public surface is the documented "
                     f"surface", node)

    # ---- lane + body walk -------------------------------------------
    def check_stmt(node, lane):
        if isinstance(node, ast.Call):
            sync = _is_sync_call(node, device_state, is_body)
            if sync is not None:
                if lane is not None and lane not in SYNC_OK_LANES:
                    emit("RL102",
                         f"{sync} inside an @lane({lane!r}) function: "
                         f"host syncs belong to the barrier lane "
                         f"(waits for the card per call)", node)
                if is_body:
                    emit("RL104",
                         f"{sync} in a stage or kernel body file: bodies "
                         f"must not force host syncs", node)
            if is_body and isinstance(node.func, ast.Name) \
                    and node.func.id == "print":
                emit("RL104", "print() in a stage or kernel body file: "
                              "bodies must be side-effect free", node)
            if lane is not None and lane_shared \
                    and isinstance(node.func, ast.Attribute):
                for attr_node in ast.walk(node.func.value):
                    if isinstance(attr_node, ast.Attribute) \
                            and attr_node.attr in lane_shared:
                        allowed = tuple(lane_shared[attr_node.attr])
                        if lane not in allowed:
                            emit("RL103",
                                 f"method call through shared attribute "
                                 f".{attr_node.attr} from lane {lane!r}; "
                                 f"LANE_SHARED allows {allowed}", node)
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            if lane is not None and lane_shared:
                for t in _flat_targets(node):
                    for attr_node in ast.walk(t):
                        if isinstance(attr_node, ast.Attribute) \
                                and attr_node.attr in lane_shared:
                            allowed = tuple(lane_shared[attr_node.attr])
                            if lane not in allowed:
                                emit("RL103",
                                     f"assignment to shared attribute "
                                     f".{attr_node.attr} from lane "
                                     f"{lane!r}; LANE_SHARED allows "
                                     f"{allowed}", node)
        elif isinstance(node, (ast.Global, ast.Nonlocal)):
            if is_body:
                kw = "global" if isinstance(node, ast.Global) else "nonlocal"
                emit("RL104", f"{kw} in a stage or kernel body file: "
                              f"bodies must be side-effect free", node)
        elif isinstance(node, (ast.If, ast.While)):
            if is_body:
                for sub in ast.walk(node.test):
                    if isinstance(sub, ast.Call):
                        c = _chain(sub.func)
                        reduced = (c in ("torch.any", "torch.all")
                                   or (isinstance(sub.func, ast.Attribute)
                                       and sub.func.attr in ("any", "all")))
                        if reduced:
                            emit("RL104",
                                 f"Python branch on a tensor reduction "
                                 f"({c or '.' + sub.func.attr + '()'}): a "
                                 f"hidden host sync; use torch.where",
                                 node)

    def walk_scope(node, lane):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walk_scope(child, _lane_of(child) or lane)
            else:
                check_stmt(child, lane)
                walk_scope(child, lane)

    walk_scope(tree, None)
    return findings


def lint_file(path) -> list:
    """Lint one file from disk; unreadable or unparsable files become a
    single ``RL000`` diagnostic instead of raising."""
    p = pathlib.Path(path)
    try:
        src = p.read_text()
    except (OSError, UnicodeDecodeError) as exc:
        return [Diagnostic("RL000", ERROR, f"unreadable: {exc}",
                           path=str(p), line=0)]
    try:
        return lint_source(src, str(p))
    except SyntaxError as exc:
        return [Diagnostic("RL000", ERROR, f"syntax error: {exc.msg}",
                           path=str(p), line=exc.lineno or 0)]


def load_allowlist(path):
    """``glob::RULE`` lines (``*`` rule matches everything); ``#`` comments."""
    entries = []
    p = pathlib.Path(path)
    if not p.exists():
        return entries
    for raw in p.read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        glob, _, rule = line.partition("::")
        entries.append((glob.strip(), (rule.strip() or "*")))
    return entries


def _allowed(diag, allowlist) -> bool:
    norm = (diag.path or "").replace("\\", "/")
    for glob, rule in allowlist:
        if rule not in ("*", diag.rule_id):
            continue
        if fnmatch.fnmatch(norm, glob):
            return True
    return False


def iter_python_files(paths):
    """Yield every ``.py`` file under ``paths`` (files pass through,
    directories recurse, ``__pycache__`` is skipped), sorted per tree."""
    for raw in paths:
        p = pathlib.Path(raw)
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if "__pycache__" not in f.parts:
                    yield f
        elif p.suffix == ".py":
            yield p


def lint_paths(paths, allowlist=()) -> list:
    """Lint files/trees; allowlisted findings are dropped."""
    findings: list = []
    for f in iter_python_files(paths):
        for d in lint_file(f):
            if not _allowed(d, allowlist):
                findings.append(d)
    return findings
