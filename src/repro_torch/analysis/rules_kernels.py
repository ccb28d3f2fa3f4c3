"""K-rules: the port's CUDA kernel bindings (``src/repro_torch/kernels``).

Port of ``repro.analysis.rules_kernels``, rewritten for the port's
kernels. The reference checks ``pl.pallas_call`` sites. The port's
kernels are CUDA C++ built into plain-C shared libraries
(``kernels/build.py``) and bound with ``ctypes``: a wrapper's ``_lib()``
takes ``build.load("<lib>").<symbol>`` and writes its ``argtypes`` by
hand against the ``extern "C"`` definition in ``csrc/<lib>.cu`` beside
it. ctypes holds neither side to the other, so a dropped ``c_int`` or an
extra argument reaches the card as wrong results or a crash, with no
error. These rules read the ``.cu`` (a regex over its ``extern "C"``
definitions, no C++ parser: a definition the regex cannot read is an
error finding, never a pass) and hold the Python side to it. The ids
keep the reference's order of concerns:

K001  binding signature: the constant-folded ``argtypes`` equals the C
      parameter list element by element (``T*`` takes ``c_void_p`` or
      ``POINTER(<ctypes of T>)``; ``int``, ``float`` and ``long long``
      take ``c_int``, ``c_float`` and ``c_longlong``), and ``restype``
      the return type. A symbol the ``.cu`` does not define, or a
      binding the rule cannot read, is an error.
K002  call arity: every call of a binding (``_lib()(...)``) passes as
      many positional arguments as the C function takes, which K001
      holds ``argtypes`` to. ctypes passes extra arguments to a cdecl
      function without a word.
K003  admitted vs instantiated shapes: the values of a wrapper's literal
      shape table (``HEAD_DIMS``; the latent ranks of ``SHAPES``; the
      (D, Dv) pairs of ``HEAD_DIM_PAIRS``) must be cases of its library's
      ``<lib>_smem_bytes(int dtype, int X)`` (``X == <literal>``) or
      ``<lib>_smem_bytes(int dtype, int X, int Y)`` (``X == <literal> &&
      Y == <literal>``), all of whose branches are read; a table of
      single values is held to the cases' X values, a table of pairs
      to a one-value function by its rows' first entries. A shape
      admitted but not instantiated fails only at launch, with
      ``cudaErrorInvalidValue`` (error); one instantiated but admitted by
      no wrapper is dead code (warning).
K004  unchecked launch and fallback: a binding call's return code is
      bound to a name, and every path from the call to the function's
      exit crosses an ``if`` on that name whose body raises; no binding
      call sits in a ``try`` whose handlers do anything but re-raise
      (the port's "raise, never fall back" rule). The reference's K004,
      an output-ref store without ``astype``, has no counterpart in C,
      so this takes its number.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.cfg import EXIT, build_cfg
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import Rule, register
from repro_torch.analysis.tables import (ADMITTED_SHAPE_TABLES, CTYPES_OF_C,
                                         KERNEL_SOURCE_DIR,
                                         KERNEL_WRAPPER_PREFIX,
                                         SMEM_FUNCTION_SUFFIX)

# ---------------------------------------------------------------- C side --
_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
# ``extern "C" <return type> <name>(<parameters>) {``, over lines
_EXTERN = re.compile(r'extern\s+"C"\s+([^(){};"]*?)\b([A-Za-z_]\w*)\s*'
                     r'\(([^()]*)\)\s*\{')
_QUALIFIERS = {"const", "volatile", "__restrict__", "restrict"}
_TYPE_WORDS = {"int", "float", "double", "long", "short", "char", "void",
               "unsigned", "signed", "bool"}


class CSourceError(ValueError):
    """A ``.cu`` text the regex cannot read."""


@dataclasses.dataclass(frozen=True)
class CType:
    base: str                 # "int", "long long", "void", ...
    pointer: bool

    def __str__(self) -> str:
        return self.base + ("*" if self.pointer else "")


@dataclasses.dataclass
class CFunction:
    name: str
    ret: CType
    params: List[Tuple[CType, Optional[str]]]     # (type, name)
    line: int
    body: str


def _c_type(text: str) -> Tuple[CType, Optional[str]]:
    """``const long long* strides`` -> (long long*, "strides")."""
    toks = [t for t in re.findall(r"[A-Za-z_]\w*|\*", text)
            if t not in _QUALIFIERS]
    words = [t for t in toks if t != "*"]
    if not words or re.sub(r"[\w\s*]", "", text):
        raise CSourceError(f"cannot read C declaration {text.strip()!r}")
    name = words.pop() if len(words) > 1 and words[-1] not in _TYPE_WORDS \
        else None
    return CType(" ".join(words), "*" in toks), name


def parse_extern_c(text: str) -> Dict[str, CFunction]:
    """Every ``extern "C"`` function defined in a ``.cu`` text, by name."""
    text = _COMMENT.sub(lambda m: "\n" * m.group().count("\n"), text)
    out: Dict[str, CFunction] = {}
    for m in _EXTERN.finditer(text):
        ret, _ = _c_type(m.group(1) + " _")
        params = [p for p in m.group(3).split(",") if p.strip()]
        if [p.strip() for p in params] == ["void"]:
            params = []
        depth, i = 0, m.end() - 1
        for i in range(m.end() - 1, len(text)):
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            if depth == 0:
                break
        out[m.group(2)] = CFunction(
            m.group(2), ret, [_c_type(p) for p in params],
            text.count("\n", 0, m.start()) + 1, text[m.end():i])
    if "extern" in text and '"C"' in text and not out:
        raise CSourceError('no extern "C" definition could be read')
    return out


def smem_cases(fn: CFunction) -> list:
    """The cases of ``<lib>_smem_bytes``, over every branch of its body:
    the ``X == <literal>`` values of ``(int dtype, int X)``, or the
    ``(x, y)`` pairs of ``X == <literal> && Y == <literal>`` of ``(int
    dtype, int X, int Y)``."""
    names = [p[1] for p in fn.params[1:]]
    if len(fn.params) not in (2, 3) or None in names:
        raise CSourceError(f"`{fn.name}` is not (int dtype, int X) or "
                           "(int dtype, int X, int Y)")
    pattern = r"\s*&&\s*".join(rf"\b{re.escape(n)}\s*==\s*(\d+)\b"
                                 for n in names)
    found = re.findall(pattern, fn.body)
    cases = sorted({int(v) if len(names) == 1 else tuple(map(int, v))
                    for v in found})
    if not cases:
        raise CSourceError(f"`{fn.name}` has no `"
                           + " && ".join(f"{n} == N" for n in names)
                           + "` case")
    return cases


def _arity(vals: list) -> int:
    return len(vals[0]) if vals and isinstance(vals[0], tuple) else 1


def _leading(vals: list, n: int) -> list:
    """``vals`` (ints or tuples) cut to their first ``n`` entries."""
    if _arity(vals) <= n:
        return sorted(set(vals))
    return sorted({v[0] if n == 1 else v[:n] for v in vals})


def _accepts(c: CType, ct: str) -> bool:
    """Whether ctypes type ``ct`` passes C type ``c``."""
    if c.pointer:
        return ct == "c_void_p" or (
            c.base in CTYPES_OF_C and c.base != "void"
            and ct == f"POINTER({CTYPES_OF_C[c.base]})")
    return CTYPES_OF_C.get(c.base) == ct


# ----------------------------------------------------------- Python side --
def _const_int(node: ast.expr, env: Dict[str, int]) -> Optional[int]:
    """Best-effort integer constant folding (literals, +-*// of
    literals, names bound to folded literals)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.BinOp):
        left = _const_int(node.left, env)
        right = _const_int(node.right, env)
        if left is None or right is None:
            return None
        if isinstance(node.op, ast.Mult):
            return left * right
        if isinstance(node.op, ast.Add):
            return left + right
        if isinstance(node.op, ast.Sub):
            return left - right
        if isinstance(node.op, ast.FloorDiv) and right:
            return left // right
    return None


def _ctype_name(node: ast.expr) -> Optional[str]:
    """``ctypes.c_int`` / ``c_int`` -> "c_int", ``None`` -> "None",
    ``ctypes.POINTER(ctypes.c_longlong)`` -> "POINTER(c_longlong)"."""
    if isinstance(node, ast.Constant) and node.value is None:
        return "None"
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "ctypes":
        return node.attr
    if isinstance(node, ast.Call) and len(node.args) == 1 \
            and _ctype_name(node.func) == "POINTER":
        inner = _ctype_name(node.args[0])
        return None if inner is None else f"POINTER({inner})"
    return None


def fold_argtypes(node: ast.expr, env: Dict[str, int]) -> Optional[List[str]]:
    """An ``argtypes`` expression folded to ctypes names: list literals,
    ``+`` of lists and ``*`` of a list by a constant, e.g.
    ``[c_void_p] * 5 + [c_int] * 10 + [c_float]``."""
    if isinstance(node, (ast.List, ast.Tuple)):
        out = [_ctype_name(e) for e in node.elts]
        return None if None in out else out
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        a, b = fold_argtypes(node.left, env), fold_argtypes(node.right, env)
        return None if a is None or b is None else a + b
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        for seq, k in ((node.left, node.right), (node.right, node.left)):
            items, n = fold_argtypes(seq, env), _const_int(k, env)
            if items is not None and n is not None:
                return items * n
    return None


def _is_build_load(node: ast.expr) -> bool:
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "load"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "build")


@dataclasses.dataclass
class Binding:
    """One ``<var> = build.load("<lib>").<symbol>`` in function ``fn``,
    with the ``<var>.argtypes`` / ``<var>.restype`` assigned there."""
    lib: str
    symbol: str
    fn: ast.FunctionDef
    line: int
    argtypes: Optional[List[str]] = None       # None: absent or unfoldable
    argtypes_line: Optional[int] = None
    restype: Optional[str] = None


class Wrapper:
    """What the K-rules read of one wrapper module and the ``.cu`` files
    it binds. ``problems`` are the binding sites the rules cannot read."""

    def __init__(self, tree: ast.Module, path: str, root: str):
        self.tree = tree
        self.path = path
        self.csrc = os.path.join(root, os.path.dirname(path),
                                 KERNEL_SOURCE_DIR)
        self.env: Dict[str, int] = {}
        for stmt in tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                val = _const_int(stmt.value, self.env)
                if val is not None:
                    self.env[stmt.targets[0].id] = val
        self.bindings: List[Binding] = []
        self.problems: List[Tuple[int, str]] = []
        self._sources: Dict[str, object] = {}
        self._calls: Optional[list] = None        # built by ``calls``
        self._names: List[ast.Name] = []
        read = set()
        for fn in ast.walk(tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._read_function(fn, read)
        for node in ast.walk(tree):
            if _is_build_load(node) and id(node) not in read:
                self.problems.append((node.lineno, (
                    "a `build.load(...)` that is not `<name> = build.load("
                    "\"<lib>\").<symbol>` inside a function: its binding "
                    "cannot be checked")))

    def _read_function(self, fn: ast.FunctionDef, read: set) -> None:
        for stmt in fn.body:
            if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and isinstance(stmt.value, ast.Attribute)
                    and _is_build_load(stmt.value.value)):
                continue
            load = stmt.value.value
            if len(load.args) != 1 or not isinstance(load.args[0],
                                                     ast.Constant) \
                    or not isinstance(load.args[0].value, str):
                continue
            read.add(id(load))
            var = stmt.targets[0].id
            b = Binding(load.args[0].value, stmt.value.attr, fn, stmt.lineno)
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1):
                    continue
                t = node.targets[0]
                if isinstance(t, ast.Attribute) and isinstance(
                        t.value, ast.Name) and t.value.id == var:
                    if t.attr == "argtypes":
                        b.argtypes = fold_argtypes(node.value, self.env)
                        b.argtypes_line = node.lineno
                    elif t.attr == "restype":
                        b.restype = _ctype_name(node.value)
            self.bindings.append(b)

    def c_function(self, lib: str, name: str):
        """The CFunction ``name`` of ``csrc/<lib>.cu``, or why it cannot
        be read (a string)."""
        if lib not in self._sources:
            try:
                with open(os.path.join(self.csrc, f"{lib}.cu"),
                          encoding="utf-8") as f:
                    self._sources[lib] = parse_extern_c(f.read())
            except OSError:
                self._sources[lib] = (f"{KERNEL_SOURCE_DIR}/{lib}.cu not "
                                      "found beside the wrapper")
            except CSourceError as exc:
                self._sources[lib] = f"{KERNEL_SOURCE_DIR}/{lib}.cu: {exc}"
        funcs = self._sources[lib]
        if isinstance(funcs, str):
            return funcs
        return funcs.get(name) or (
            f"{KERNEL_SOURCE_DIR}/{lib}.cu defines no extern \"C\" `{name}` "
            "that this rule can read")

    def calls(self, b: Binding):
        """(call, statement, function) of every ``<b.fn>()(...)``; and the
        lines where ``b.fn`` is used any other way."""
        if self._calls is None:
            owner = {}          # statement -> its innermost function
            for fn in ast.walk(self.tree):
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    owner.update((s, fn) for s in ast.walk(fn)
                                 if isinstance(s, ast.stmt) and s is not fn)
            self._calls = [(node, stmt, fn) for stmt, fn in owner.items()
                           for node in _own_exprs(stmt)
                           if isinstance(node, ast.Call)
                           and isinstance(node.func, ast.Call)
                           and isinstance(node.func.func, ast.Name)
                           and not node.func.args]
            self._names = [n for n in ast.walk(self.tree)
                           if isinstance(n, ast.Name)]
        calls = [c for c in self._calls if c[0].func.func.id == b.fn.name]
        direct = {id(c.func.func) for c, _, _ in calls}
        other = [n.lineno for n in self._names
                 if n.id == b.fn.name and id(n) not in direct]
        return calls, other

    def tables(self):
        """[(name, line, values or None)] of the module's literal shape
        tables (``ADMITTED_SHAPE_TABLES``)."""
        out = []
        for stmt in self.tree.body:
            if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and stmt.targets[0].id in ADMITTED_SHAPE_TABLES):
                continue
            name = stmt.targets[0].id
            try:
                rows = ast.literal_eval(stmt.value)
                col = ADMITTED_SHAPE_TABLES[name]
                vals = sorted({
                    int(r) if col is None else
                    tuple(int(r[c]) for c in col) if isinstance(col, tuple)
                    else int(r[col]) for r in rows})
            except (ValueError, TypeError, IndexError, SyntaxError):
                vals = None
            out.append((name, stmt.lineno, vals))
        return out


def _named(node: ast.AST, name: str) -> bool:
    return isinstance(node, ast.Name) and node.id == name


def _own_exprs(stmt: ast.stmt):
    """A statement's own expression nodes, not those of nested
    statements (each call belongs to its innermost statement)."""
    stack: list = [c for c in ast.iter_child_nodes(stmt)
                   if not isinstance(c, ast.stmt)]
    while stack:
        n = stack.pop()
        yield n
        stack.extend(c for c in ast.iter_child_nodes(n)
                     if not isinstance(c, ast.stmt))


class _KernelRule(Rule):
    family = "K"

    def applies(self, path: str) -> bool:
        rest = path[len(KERNEL_WRAPPER_PREFIX):]
        return path.startswith(KERNEL_WRAPPER_PREFIX) and "/" not in rest \
            and rest.endswith(".py")

    def check(self, tree, src, path) -> List[Finding]:
        from repro_torch.analysis.runner import _infer_root
        return self.run(tree, src, path, _infer_root())

    def run(self, tree, src, path, root) -> List[Finding]:
        return self.check_wrapper(Wrapper(tree, path, root))

    def check_wrapper(self, w: Wrapper) -> List[Finding]:
        raise NotImplementedError


@register
class BindingSignatureRule(_KernelRule):
    rule_id = "K001"
    severity = "error"
    description = ("ctypes argtypes/restype of a kernel binding differ from "
                   "its extern \"C\" definition in csrc/<lib>.cu")

    def check_wrapper(self, w: Wrapper) -> List[Finding]:
        out = [self.finding(w.path, line, msg) for line, msg in w.problems]
        for b in w.bindings:
            cf = w.c_function(b.lib, b.symbol)
            if isinstance(cf, str):
                out.append(self.finding(w.path, b.line, cf))
                continue
            if b.argtypes is None:
                out.append(self.finding(
                    w.path, b.argtypes_line or b.line,
                    f"`{b.symbol}`'s argtypes are not set to a list this "
                    "rule can fold (literals, +, * by a constant)"))
            else:
                want = [t for t, _ in cf.params]
                bad = [f"#{i} {c} <- {t}" for i, (c, t) in
                       enumerate(zip(want, b.argtypes)) if not _accepts(c, t)]
                if len(want) != len(b.argtypes) or bad:
                    out.append(self.finding(
                        w.path, b.argtypes_line,
                        f"`{b.symbol}` argtypes has {len(b.argtypes)} "
                        f"entries, {b.lib}.cu:{cf.line} takes {len(want)} "
                        "parameters" + (f"; mismatched: {', '.join(bad)}"
                                        if bad else "")))
            if b.restype is None or not _accepts(cf.ret, b.restype):
                out.append(self.finding(
                    w.path, b.line,
                    f"`{b.symbol}` restype is {b.restype or 'not set'}, "
                    f"{b.lib}.cu:{cf.line} returns {cf.ret}"))
        return out


@register
class CallArityRule(_KernelRule):
    rule_id = "K002"
    severity = "error"
    description = ("a kernel binding is called with another number of "
                   "arguments than its C function takes")

    def check_wrapper(self, w: Wrapper) -> List[Finding]:
        out: List[Finding] = []
        for b in w.bindings:
            cf = w.c_function(b.lib, b.symbol)
            want = len(cf.params) if not isinstance(cf, str) else (
                len(b.argtypes) if b.argtypes is not None else None)
            calls, other = w.calls(b)
            for line in other:
                out.append(self.finding(
                    w.path, line,
                    f"`{b.fn.name}` is used other than as "
                    f"`{b.fn.name}()(...)`: that call's arity cannot be "
                    "checked"))
            for call, _, _ in calls:
                if call.keywords or any(isinstance(a, ast.Starred)
                                        for a in call.args):
                    out.append(self.finding(
                        w.path, call.lineno,
                        f"`{b.fn.name}()(...)` passes keyword or starred "
                        "arguments: its arity cannot be checked"))
                elif want is None:
                    out.append(self.finding(
                        w.path, call.lineno,
                        f"`{b.symbol}`: neither the C definition nor "
                        "argtypes can be read to check this call"))
                elif len(call.args) != want:
                    out.append(self.finding(
                        w.path, call.lineno,
                        f"`{b.fn.name}()(...)` passes {len(call.args)} "
                        f"arguments, `{b.symbol}` takes {want}; ctypes "
                        "passes the extra ones on (or fails only at run "
                        "time on too few)"))
        return out


@register
class AdmittedShapeRule(_KernelRule):
    rule_id = "K003"
    severity = "error"
    description = ("a wrapper admits a shape its library does not "
                   "instantiate (or instantiates one no wrapper admits)")

    def check_wrapper(self, w: Wrapper) -> List[Finding]:
        out: List[Finding] = []
        if not w.bindings:
            return out
        tables = w.tables()
        if not tables:
            return [self.finding(
                w.path, w.bindings[0].line,
                "binds a kernel but has no literal shape table "
                f"({' / '.join(ADMITTED_SHAPE_TABLES)}) to admit on")]
        for name, line, vals in tables:
            if vals is None:
                out.append(self.finding(
                    w.path, line, f"`{name}` is not a literal table"))
                continue
            for lib in dict.fromkeys(b.lib for b in w.bindings):
                smem = lib + SMEM_FUNCTION_SUFFIX
                cf = w.c_function(lib, smem)
                try:
                    if isinstance(cf, str):
                        raise CSourceError(cf)
                    cases = smem_cases(cf)
                except CSourceError as exc:
                    out.append(self.finding(
                        w.path, line, f"cannot read the shapes {lib} "
                        f"instantiates: {exc}"))
                    continue
                n = min(_arity(vals), _arity(cases))
                have, cases = _leading(vals, n), _leading(cases, n)
                missing = sorted(set(have) - set(cases))
                if missing:
                    out.append(self.finding(
                        w.path, line,
                        f"`{name}` admits {missing}, which {lib}.cu does "
                        f"not instantiate ({smem} cases {cases}): the "
                        "launch fails with cudaErrorInvalidValue"))
                unused = sorted(set(cases) - set(have))
                if unused:
                    out.append(self.finding(
                        w.path, line,
                        f"{lib}.cu instantiates {unused} ({smem}), which "
                        f"`{name}` does not admit", severity="warning"))
        return out


@register
class UncheckedLaunchRule(_KernelRule):
    rule_id = "K004"
    severity = "error"
    description = ("a kernel launch's return code is dropped or not raised "
                   "on, or a try around it falls back instead of raising")

    def check_wrapper(self, w: Wrapper) -> List[Finding]:
        out: List[Finding] = []
        for b in w.bindings:
            calls, _ = w.calls(b)
            for call, stmt, fn in calls:
                out.extend(self._check_call(w.path, b, call, stmt, fn))
        return out

    def _check_call(self, path, b, call, stmt, fn) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Try) and any(
                    stmt is n for s in node.body for n in ast.walk(s)):
                swallows = [h for h in node.handlers
                            if not (len(h.body) == 1
                                    and isinstance(h.body[0], ast.Raise))]
                swallows += [s for s in node.finalbody
                             for n in ast.walk(s)
                             if isinstance(n, ast.Return)]
                if swallows:
                    out.append(self.finding(
                        path, swallows[0].lineno,
                        f"`{b.symbol}` launches inside a try that "
                        "does not re-raise: a failed launch must raise, "
                        "never fall back"))
        if not (isinstance(stmt, ast.Assign) and stmt.value is call
                and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)):
            out.append(self.finding(
                path, stmt.lineno,
                f"the return code of `{b.symbol}` is not bound to a name: "
                "a failed launch would pass unnoticed"))
            return out
        err = stmt.targets[0].id
        checks = {s for s in ast.walk(fn)
                  if isinstance(s, ast.If)
                  and any(_named(n, err) for n in ast.walk(s.test))
                  and any(isinstance(n, ast.Raise)
                          for s2 in s.body for n in ast.walk(s2))}
        if build_cfg(fn).path_avoiding(stmt, EXIT, checks):
            out.append(self.finding(
                path, stmt.lineno,
                f"a path from `{b.symbol}`'s launch leaves `{fn.name}` "
                f"without an `if {err}: raise ...`"))
        return out


def binding_table(root: str) -> List[Dict]:
    """What the K-rules read, one row per binding of every wrapper in
    ``src/repro_torch/kernels``: module, binding function, library,
    symbol, the folded ``argtypes`` length, the C parameter count, the
    admitted values of its shape tables and the ``<lib>_smem_bytes``
    cases. ``chip_smoke.py`` holds them to the built libraries."""
    rows = []
    kdir = os.path.join(root, KERNEL_WRAPPER_PREFIX)
    for fn in sorted(os.listdir(kdir)):
        if not fn.endswith(".py"):
            continue
        path = KERNEL_WRAPPER_PREFIX + fn
        with open(os.path.join(kdir, fn), encoding="utf-8") as f:
            w = Wrapper(ast.parse(f.read()), path, root)
        tables = [vals for _, _, vals in w.tables() if vals]
        for b in w.bindings:
            cf = w.c_function(b.lib, b.symbol)
            smem = w.c_function(b.lib, b.lib + SMEM_FUNCTION_SUFFIX)
            n = 1 if isinstance(smem, str) else len(smem.params) - 1
            # the shapes admitted in the function's arity (a table of
            # fewer values a row gives none)
            admitted = sorted({v for vals in tables if _arity(vals) >= n
                               for v in _leading(vals, n)})
            rows.append({
                "module": path[len("src/"):-len(".py")].replace("/", "."),
                "function": b.fn.name, "lib": b.lib, "symbol": b.symbol,
                "argtypes": None if b.argtypes is None else len(b.argtypes),
                "c_params": None if isinstance(cf, str) else len(cf.params),
                "admitted": admitted,
                "instantiated": None if isinstance(smem, str)
                else smem_cases(smem)})
    return rows
