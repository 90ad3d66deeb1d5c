"""Determinism linting of the data plane and kernels (sc-lint pass family 2),
the counterpart of ``repro.analysis.determinism``.

Two layers, both encoding hazards the reference shipped and fixed:

**Source (AST) lints** over ``mv/`` and ``kernels/``, the reference's rules
under the reference's names:

* ``unstable-sort`` — a permutation sort that does not promise a stable
  order: numpy's ``argsort`` without ``kind="stable"`` (or
  ``"mergesort"``), and ``torch.sort`` or any ``*.argsort`` call without
  ``stable=True``. An unstable grouping sort feeding an order-sensitive
  consumer breaks bitwise equivalence across runs and devices. A tensor's
  ``.sort()`` method is not flagged: from the source alone it cannot be
  told apart from a Python list's ``.sort()``, which is stable.
* ``static-arg-retrace`` — ``jax.jit(..., static_argnums=/static_argnames=)``
  marking a *value-like* parameter static (the historical ``_filter_mask``
  bug). The port jits nothing; the rule stays so that the filter-mask
  fixtures keep their must-fire / must-stay-quiet contract.
* ``x64-leak`` — ``jax.config.update("jax_enable_x64", ...)`` in a function
  with no restoring update inside a ``finally``/``except`` handler.

**PTX lints** over the data-plane kernels as ``nvcc`` compiles them
(``csrc/dataplane.cu`` under ``native.PTX_FLAGS``: the flags the shipped
library is built with, no fast-math). The PTX is the port's IR, as the jaxpr
is the reference's: each ``.entry`` is linted with every ``.func`` it
reaches through ``call``, on float operands only:

* ``transcendental-kernel`` — any ``.approx`` instruction (``ex2``, ``lg2``,
  ``sin``, ``cos``, ``tanh``, ``rcp``, ``rsqrt``, ``sqrt``, ``div``) and
  ``div.full``: their results are not correctly rounded. IEEE ``div.rn``,
  ``sqrt.rn`` and ``rcp.rn`` stay quiet.
* ``fma-contraction`` — ``fma``/``mad`` on ``.f32``/``.f64``, or a
  ``mul``/``add``/``sub`` on them with no rounding modifier, which ptxas
  may contract into an FMA: either changes the low bit against the
  unfused numpy reference. ``mul.rn.f32`` (what ``__fmul_rn`` gives) is
  quiet.
* ``f32-downcast`` — a float conversion into a narrower float
  (``cvt.rn.f32.f64``, into ``f16``/``bf16``): precision loss the table
  contract does not declare.
* ``flush-to-zero`` — a ``.ftz`` float instruction that is not already
  ``.approx`` (``add.rn.ftz.f32``, ``setp.gt.ftz.f32``): it flushes
  subnormals to zero, which numpy does not.

Model kernels (``csrc/rmsnorm.cu``, the flash and SSD sources) are out of
scope, as in the reference: they carry no bitwise contract.
"""
from __future__ import annotations

import ast
import bisect
import dataclasses
import re
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

from .. import native
from .findings import Finding

__all__ = [
    "SIZE_LIKE_STATIC_ARGS",
    "lint_source",
    "lint_file",
    "lint_paths",
    "PtxFunction",
    "parse_ptx",
    "kernel_name",
    "lint_ptx",
    "DATAPLANE_KERNELS",
    "DATAPLANE_SOURCE",
    "lint_dataplane_kernels",
    "DEFAULT_LINT_GLOBS",
]

# static jit arguments that are legitimately shape-like: few distinct values
# over a process lifetime, each changing the traced program's shapes/control
# flow. Anything else marked static is treated as value-like.
SIZE_LIKE_STATIC_ARGS = frozenset({
    "P", "n", "L", "steps", "chunk", "chunks", "axis", "ndim", "width",
    "depth", "block", "block_q", "block_k", "bq", "bk", "interpret",
    "causal", "heads", "dim", "n_partitions",
})

DEFAULT_LINT_GLOBS = ("src/repro_torch/mv/*.py", "src/repro_torch/kernels/*.py")

STABLE_KINDS = ("stable", "mergesort")


# ---------------------------------------------------------------------------
# AST lints
# ---------------------------------------------------------------------------

def _const(node):
    return node.value if isinstance(node, ast.Constant) else None


def _call_name(func: ast.AST) -> str:
    """Dotted name of a call target, best effort ('jax.jit', 'np.argsort')."""
    parts: list[str] = []
    while isinstance(func, ast.Attribute):
        parts.append(func.attr)
        func = func.value
    if isinstance(func, ast.Name):
        parts.append(func.id)
    return ".".join(reversed(parts))


def _static_names(call: ast.Call, fn_params: list[str] | None) -> list[str]:
    """Parameter names a jax.jit call marks static (best effort)."""
    names: list[str] = []
    for kw in call.keywords:
        if kw.arg == "static_argnames":
            v = _const(kw.value)
            if isinstance(v, str):
                names.append(v)
            elif isinstance(kw.value, (ast.Tuple, ast.List)):
                names.extend(
                    c for c in (_const(e) for e in kw.value.elts)
                    if isinstance(c, str)
                )
        elif kw.arg == "static_argnums" and fn_params is not None:
            idxs: list[int] = []
            v = _const(kw.value)
            if isinstance(v, int):
                idxs = [v]
            elif isinstance(kw.value, (ast.Tuple, ast.List)):
                idxs = [
                    c for c in (_const(e) for e in kw.value.elts)
                    if isinstance(c, int)
                ]
            for i in idxs:
                if 0 <= i < len(fn_params):
                    names.append(fn_params[i])
    return names


def _stable_sort(name: str, call: ast.Call) -> bool:
    """Whether a sort call promises a stable order: numpy's ``kind``
    (keyword, or argsort's third positional argument) or ``stable=True``."""
    kinds = [_const(kw.value) for kw in call.keywords if kw.arg == "kind"]
    if name.endswith("argsort") and len(call.args) >= 3:
        kinds.append(_const(call.args[2]))
    stable = any(kw.arg == "stable" and _const(kw.value) is True
                 for kw in call.keywords)
    return stable or any(k in STABLE_KINDS for k in kinds)


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.findings: list[Finding] = []
        self.fn_stack: list[str] = ["<module>"]
        self.restore_depth = 0  # inside a finally block / except handler
        # functions defined at any scope, for static_argnums resolution
        self.fn_defs: dict[str, ast.FunctionDef] = {}
        # per-function x64 bookkeeping: [(enable_call, in_restore)]
        self.x64_calls: dict[str, list[tuple[ast.Call, bool]]] = {}

    # -- scope tracking ----------------------------------------------------
    def _collect_defs(self, tree: ast.AST):
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.fn_defs.setdefault(node.name, node)

    def visit_FunctionDef(self, node: ast.FunctionDef):
        self.fn_stack.append(node.name)
        self.generic_visit(node)
        self.fn_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Try(self, node: ast.Try):
        for part in (node.body, node.orelse):
            for child in part:
                self.visit(child)
        self.restore_depth += 1
        for handler in node.handlers:
            for child in handler.body:
                self.visit(child)
        for child in node.finalbody:
            self.visit(child)
        self.restore_depth -= 1

    # -- rules -------------------------------------------------------------
    def visit_Call(self, node: ast.Call):
        name = _call_name(node.func)
        symbol = self.fn_stack[-1]

        if (name.endswith("argsort") or name == "torch.sort") and \
                not _stable_sort(name, node):
            self.findings.append(Finding(
                "unstable-sort", "warning", self.path, symbol,
                f"{name} without kind=\"stable\" or stable=True: ties "
                "reorder freely; only order-insensitive consumers (exact "
                "integer sums) may consume this permutation",
                node.lineno,
            ))

        if name.endswith(".jit") or name == "jit":
            fn_params = None
            if node.args and isinstance(node.args[0], ast.Name):
                fndef = self.fn_defs.get(node.args[0].id)
                if fndef is not None:
                    fn_params = [a.arg for a in fndef.args.args]
            for pname in _static_names(node, fn_params):
                if pname not in SIZE_LIKE_STATIC_ARGS:
                    self.findings.append(Finding(
                        "static-arg-retrace", "warning", self.path,
                        symbol if symbol != "<module>" else (
                            node.args[0].id if node.args and
                            isinstance(node.args[0], ast.Name) else symbol
                        ),
                        f"static jit argument {pname!r} looks value-like: "
                        "every distinct value triggers a full retrace "
                        "(pass it traced, or allowlist a genuinely "
                        "shape-like name)",
                        node.lineno,
                    ))

        if name.endswith("config.update") and node.args and \
                _const(node.args[0]) == "jax_enable_x64":
            self.x64_calls.setdefault(symbol, []).append(
                (node, self.restore_depth > 0)
            )

        self.generic_visit(node)

    def finish(self):
        for symbol, calls in self.x64_calls.items():
            if any(in_restore for _, in_restore in calls):
                continue  # a restoring update exists in finally/except
            node = calls[0][0]
            self.findings.append(Finding(
                "x64-leak", "warning", self.path, symbol,
                "jax_enable_x64 flipped with no restoring update in a "
                "finally/except path: an error after the flip leaks global "
                "x64 state into unrelated code",
                node.lineno,
            ))


def lint_source(text: str, path: str = "<string>") -> list[Finding]:
    """AST-lint one source string (fixtures lint snippets this way)."""
    tree = ast.parse(text)
    linter = _Linter(path)
    linter._collect_defs(tree)
    linter.visit(tree)
    linter.finish()
    return linter.findings


def lint_file(path: str | Path, repo_root: str | Path | None = None
              ) -> list[Finding]:
    p = Path(path)
    rel = str(p.relative_to(repo_root)) if repo_root else str(p)
    return lint_source(p.read_text(), rel)


def lint_paths(
    repo_root: str | Path, globs: Sequence[str] = DEFAULT_LINT_GLOBS
) -> list[Finding]:
    root = Path(repo_root)
    out: list[Finding] = []
    for g in globs:
        for p in sorted(root.glob(g)):
            out.extend(lint_file(p, root))
    return out


# ---------------------------------------------------------------------------
# PTX lints
# ---------------------------------------------------------------------------

# Every kernel of csrc/dataplane.cu, by its C++ name; each is linted in every
# instantiation the source makes.
DATAPLANE_KERNELS = (
    "filter_gt_kernel", "filter_gt_vec_kernel", "map_two_kernel",
    "map_one_kernel", "encode_kernel", "probe_tree_build_kernel",
    "probe_tree_kernel", "hash64_kernel", "pid_hist_kernel",
)
DATAPLANE_SOURCE = "src/repro_torch/csrc/dataplane.cu"

# PTX float types and their widths in bits.
_FLOAT_BITS = {"f64": 64, "f32": 32, "tf32": 19, "f16": 16, "f16x2": 16,
               "bf16": 16, "bf16x2": 16, "e4m3x2": 8, "e5m2x2": 8}
_WIDE_FLOATS = frozenset({"f32", "f64"})
_ROUNDINGS = frozenset({"rn", "rz", "rm", "rp"})

_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_HEADER = re.compile(r"\.(entry|func)\s*(?:\([^)]*\)\s*)?([A-Za-z_$][\w$]*)")
# one statement: leading braces and labels, a guard predicate, the opcode
_STATEMENT = re.compile(
    r"(?:[\s{}]|[\w$]+:)*(?:@!?%?[\w$]+\s+)?([a-z][\w.]*)(.*)", re.S)
_CALL_TARGET = re.compile(r"\s*(?:\([^)]*\)\s*,\s*)?([A-Za-z_$][\w$]*)")


@dataclasses.dataclass(frozen=True)
class PtxFunction:
    """One ``.entry`` or ``.func`` of a PTX module: its (mangled) name and
    its instructions as ``(line, opcode, operands)``, directives left out."""
    name: str
    kind: str  # "entry" | "func"
    instructions: tuple[tuple[int, str, str], ...]

    def calls(self) -> list[str]:
        """Names of the functions this one calls directly (an indirect call
        through a register names none)."""
        out = []
        for _, op, args in self.instructions:
            if op.split(".")[0] == "call":
                m = _CALL_TARGET.match(args)
                if m:
                    out.append(m.group(1))
        return out


def _matching_brace(text: str, i: int) -> int:
    depth = 0
    for j in range(i, len(text)):
        if text[j] == "{":
            depth += 1
        elif text[j] == "}":
            depth -= 1
            if depth == 0:
                return j
    raise ValueError(f"unbalanced braces in PTX at offset {i}")


def parse_ptx(text: str) -> dict[str, PtxFunction]:
    """Split a PTX module into its functions with bodies, by name.
    Declarations without a body (``.extern .func``) and data initialisers
    are skipped."""
    # comments blanked out, newlines kept, so offsets still map to lines
    src = _COMMENT.sub(lambda m: re.sub(r"[^\n]", " ", m.group()), text)
    newlines = [i for i, c in enumerate(src) if c == "\n"]
    funcs: dict[str, PtxFunction] = {}
    start = i = 0
    while i < len(src):
        c = src[i]
        if c == ";":
            start = i + 1
        elif c == "{":
            end = _matching_brace(src, i)
            head = _HEADER.search(src, start, i)
            if head is not None:
                kind, name = head.groups()
                funcs[name] = PtxFunction(
                    name, kind, tuple(_instructions(src, i + 1, end, newlines)))
            i, start = end, end + 1
        i += 1
    return funcs


def _instructions(src: str, begin: int, end: int, newlines: list[int]):
    pos = begin
    for piece in src[begin:end].split(";"):
        m = _STATEMENT.match(piece)
        if m is not None:
            line = bisect.bisect_right(newlines, pos + m.start(1)) + 1
            yield line, m.group(1), " ".join(m.group(2).split())
        pos += len(piece) + 1


def kernel_name(symbol: str) -> str:
    """A kernel's C++ name from its mangled PTX symbol: the last name of a
    nested name (``_ZN12_GLOBAL__N_116filter_gt_kernelIffEEv...`` ->
    ``filter_gt_kernel``), the first of a plain one, the symbol itself
    when it is not mangled (``extern "C"``)."""
    m = re.match(r"_Z(N?)", symbol)
    if m is None:
        return symbol
    nested, i, last = m.group(1) == "N", m.end(), None
    while i < len(symbol) and symbol[i].isdigit():
        j = i
        while symbol[j].isdigit():
            j += 1
        n = int(symbol[i:j])
        last, i = symbol[j:j + n], j + n
        if not nested:
            break
    return last or symbol


def _cu_filt() -> str | None:
    found = shutil.which("cu++filt")
    if found is None:
        cand = native.cuda_home() / "bin" / "cu++filt"
        found = str(cand) if cand.exists() else None
    return found


def _demangled(names: Sequence[str]) -> dict[str, str]:
    """Readable names (``cu++filt``) of the given symbols; a symbol stands
    for itself where the tool is missing."""
    tool = _cu_filt()
    if tool is None or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names) + "\n",
                         capture_output=True, text=True, check=True, timeout=60)
    lines = out.stdout.splitlines()
    return dict(zip(names, lines)) if len(lines) == len(names) else \
        {n: n for n in names}


def _op_rules(op: str) -> list[tuple[str, str]]:
    """The rules one PTX opcode trips, as (rule, why)."""
    base, *mods = op.split(".")
    types = [m for m in mods if m in _FLOAT_BITS]
    out = []
    approx = "approx" in mods or (base == "div" and "full" in mods)
    if approx:
        out.append(("transcendental-kernel",
                    "an approximate instruction is not correctly rounded: "
                    "its result may differ from the numpy reference's"))
    wide = _WIDE_FLOATS.intersection(types)
    if wide and (base in ("fma", "mad") or (
            base in ("mul", "add", "sub") and not _ROUNDINGS.intersection(mods))):
        out.append(("fma-contraction",
                    "a fused multiply-add, or a mul/add/sub without a "
                    "rounding modifier that ptxas may contract into one, "
                    "changes the low bit against the unfused reference: "
                    "spell it with the _rn intrinsics (dataplane.cu's "
                    "mul_rn / add_rn)"))
    if "ftz" in mods and types and not approx:
        out.append(("flush-to-zero",
                    "a .ftz instruction flushes subnormal inputs and results "
                    "to zero, where the numpy reference keeps them"))
    if base == "cvt" and len(types) == 2 and \
            _FLOAT_BITS[types[0]] < _FLOAT_BITS[types[1]]:
        out.append(("f32-downcast",
                    f"silent {types[1]}->{types[0]} downcast inside a "
                    "bitwise data path: precision loss the table contract "
                    "does not declare"))
    return out


def _reached(funcs: dict[str, PtxFunction], entry: str) -> list[PtxFunction]:
    """An entry and every function it reaches through calls, each once."""
    order, stack, seen = [], [entry], set()
    while stack:
        name = stack.pop()
        if name in seen or name not in funcs:
            continue
        seen.add(name)
        order.append(funcs[name])
        stack.extend(reversed(funcs[name].calls()))
    return order


def _lint_entries(funcs, entries, symbol, path, labels) -> list[Finding]:
    out = []
    for entry in entries:
        # one finding per (rule, opcode, function): its count and first line
        hits: dict[tuple[str, str, str], list] = {}
        for fn in _reached(funcs, entry):
            for line, op, _ in fn.instructions:
                for rule, why in _op_rules(op):
                    hit = hits.setdefault((rule, op, fn.name), [0, line, why])
                    hit[0] += 1
        for (rule, op, where), (count, line, why) in hits.items():
            via = "" if where == entry else f" via .func {where}"
            out.append(Finding(
                rule, "warning", path, symbol,
                f"{count} x {op} in {labels.get(entry, entry)}{via}: {why}",
                line,
            ))
    return out


def lint_ptx(text: str, symbol: str, path: str = "<ptx>",
             kernel: str | None = None) -> list[Finding]:
    """Lint every ``.entry`` of a PTX module (those whose C++ name is
    ``kernel``, when given), each with the ``.func`` bodies it reaches,
    under ``symbol``."""
    funcs = parse_ptx(text)
    entries = [f.name for f in funcs.values() if f.kind == "entry" and
               (kernel is None or kernel_name(f.name) == kernel)]
    return _lint_entries(funcs, entries, symbol, path, _demangled(entries))


def lint_dataplane_kernels() -> tuple[list[Finding], dict[str, tuple[int, int]]]:
    """Compile ``csrc/dataplane.cu`` to PTX (``native.build_ptx``) and lint
    every entry under its kernel's name. Returns the findings and, per
    kernel of ``DATAPLANE_KERNELS``, (instantiations, PTX instructions read
    over its entries and the functions they reach). A listed kernel with no
    entry gives a ``lint-skipped`` info finding; so does a machine without
    ``nvcc``, in place of every other."""
    if native.nvcc_path() is None:
        return [Finding(
            "lint-skipped", "info", DATAPLANE_SOURCE, "dataplane.cu",
            "nvcc unavailable: PTX lints skipped",
        )], {}
    funcs = parse_ptx(native.build_ptx("dataplane"))
    by_kernel: dict[str, list[str]] = {}
    for f in funcs.values():
        if f.kind == "entry":
            by_kernel.setdefault(kernel_name(f.name), []).append(f.name)
    labels = _demangled([n for names in by_kernel.values() for n in names])
    out: list[Finding] = []
    counts: dict[str, tuple[int, int]] = {}
    for kernel in DATAPLANE_KERNELS:
        if kernel not in by_kernel:
            out.append(Finding(
                "lint-skipped", "info", DATAPLANE_SOURCE, kernel,
                "kernel no longer exists; update DATAPLANE_KERNELS",
            ))
    for kernel, entries in sorted(by_kernel.items()):
        out.extend(_lint_entries(funcs, entries, kernel, DATAPLANE_SOURCE, labels))
        counts[kernel] = (len(entries), sum(
            len(fn.instructions) for e in entries for fn in _reached(funcs, e)))
    return out, counts
