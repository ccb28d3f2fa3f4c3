"""A small statement-level control-flow graph over one function's AST.

Port of ``repro.analysis.cfg``, a copy. The port's K004 walks it too
(a launch's return code checked on every path).

Built for the R-rules' acquire/release reachability question: "is there
a path from this acquire statement to a function exit that avoids every
matching release?". Nodes are statements (identified by object), edges
follow structured control flow:

  * ``if`` branches, ``for``/``while`` loops (with ``break``/
    ``continue`` and ``else`` clauses),
  * ``try``: every statement in the try body may also jump to each
    handler (exceptions can occur anywhere), handlers and body route
    through ``finally``,
  * ``return`` / ``raise`` edge to EXIT -- through enclosing ``finally``
    blocks, innermost first,
  * ``with`` bodies are inlined (context-manager cleanup is not a
    release site in this codebase's tables).

The graph is conservative in the safe direction for a linter: it may
contain infeasible paths (flagging at worst a spurious finding, fixed
with a waiver) but never drops a feasible one.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set

ENTRY = "<entry>"
EXIT = "<exit>"


class CFG:
    def __init__(self) -> None:
        self.succ: Dict[object, Set[object]] = {ENTRY: set(), EXIT: set()}

    def add_edge(self, a: object, b: object) -> None:
        self.succ.setdefault(a, set()).add(b)
        self.succ.setdefault(b, set())

    def statements(self) -> List[ast.stmt]:
        return [n for n in self.succ if isinstance(n, ast.stmt)]

    def reachable(self, sources: Iterable[object],
                  avoiding: Set[object]) -> Set[object]:
        """Nodes reachable from ``sources`` without ENTERING any node in
        ``avoiding`` (source nodes themselves are expanded)."""
        seen: Set[object] = set()
        stack = [s for s in sources if s in self.succ]
        while stack:
            n = stack.pop()
            if n in seen:
                continue
            seen.add(n)
            for m in self.succ.get(n, ()):
                if m not in seen and m not in avoiding:
                    stack.append(m)
        return seen

    def path_avoiding(self, start: object, goal: object,
                      avoiding: Set[object]) -> bool:
        """True iff a path start -> goal exists that never enters an
        ``avoiding`` node (start itself is allowed to be in it)."""
        if start == goal:
            return True
        return goal in self.reachable([start], avoiding)


class _Builder:
    """One pass over a function body; loop/finally context on a stack."""

    def __init__(self) -> None:
        self.cfg = CFG()
        # stack of (break_targets, continue_target) for enclosing loops
        self._loops: List[tuple] = []
        # stack of enclosing finally bodies (innermost last)
        self._finallies: List[List[ast.stmt]] = []

    # ------------------------------------------------------------ helpers --
    def _jump_exit(self, node: ast.stmt) -> None:
        """return/raise: route through enclosing finally blocks to EXIT."""
        prev: object = node
        for fin in reversed(self._finallies):
            if fin:
                self.cfg.add_edge(prev, fin[0])
                prev = self._block_tail(fin)
                if prev is None:        # finally itself always jumps
                    return
        self.cfg.add_edge(prev, EXIT)

    def _block_tail(self, body: List[ast.stmt]) -> Optional[object]:
        """Last fall-through node of an already-built block (None when
        the block cannot fall through)."""
        # blocks are built before this is consulted; fall-through is the
        # last statement unless it is a terminal jump
        if not body:
            return None
        last = body[-1]
        if isinstance(last, (ast.Return, ast.Raise, ast.Break, ast.Continue)):
            return None
        return last

    def build(self, fn: ast.FunctionDef) -> CFG:
        tails = self._body(fn.body, [ENTRY])
        for t in tails:
            self.cfg.add_edge(t, EXIT)
        return self.cfg

    def _body(self, body: List[ast.stmt],
              preds: List[object]) -> List[object]:
        """Wire ``body`` after ``preds``; returns the fall-through tails."""
        cur = preds
        for stmt in body:
            cur = self._stmt(stmt, cur)
        return cur

    # --------------------------------------------------------- statements --
    def _stmt(self, node: ast.stmt, preds: List[object]) -> List[object]:
        for p in preds:
            self.cfg.add_edge(p, node)
        if isinstance(node, (ast.Return, ast.Raise)):
            self._jump_exit(node)
            return []
        if isinstance(node, ast.Break):
            if self._loops:
                self._loops[-1][0].append(node)
            else:
                self.cfg.add_edge(node, EXIT)
            return []
        if isinstance(node, ast.Continue):
            if self._loops:
                self.cfg.add_edge(node, self._loops[-1][1])
            else:
                self.cfg.add_edge(node, EXIT)
            return []
        if isinstance(node, ast.If):
            then_tails = self._body(node.body, [node])
            else_tails = (self._body(node.orelse, [node])
                          if node.orelse else [node])
            return then_tails + else_tails
        if isinstance(node, (ast.For, ast.While, ast.AsyncFor)):
            breaks: List[object] = []
            self._loops.append((breaks, node))
            body_tails = self._body(node.body, [node])
            for t in body_tails:
                self.cfg.add_edge(t, node)      # loop back
            self._loops.pop()
            # loop may not execute / finishes: fall through (via else)
            after: List[object] = [node]
            if node.orelse:
                after = self._body(node.orelse, [node])
            return after + breaks
        if isinstance(node, ast.Try):
            fin = node.finalbody or []
            if fin:
                self._finallies.append(fin)
            body_tails = self._body(node.body, [node])
            handler_tails: List[object] = []
            handler_entries: List[object] = []
            for h in node.handlers:
                ht = self._body(h.body, [node])
                handler_tails += ht
                if h.body:
                    handler_entries.append(h.body[0])
            # any statement in the try body may raise into any handler
            body_nodes = [n for n in ast.walk(node)
                          if isinstance(n, ast.stmt) and n is not node
                          and self._inside(node.body, n)]
            for bn in body_nodes:
                for he in handler_entries:
                    self.cfg.add_edge(bn, he)
            else_tails = (self._body(node.orelse, body_tails)
                          if node.orelse else body_tails)
            tails = else_tails + handler_tails
            if fin:
                self._finallies.pop()
                fin_tails = self._body(fin, tails or [node])
                return fin_tails
            return tails
        if isinstance(node, (ast.With, ast.AsyncWith)):
            return self._body(node.body, [node])
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return [node]                       # nested defs: opaque
        return [node]

    @staticmethod
    def _inside(body: List[ast.stmt], node: ast.stmt) -> bool:
        for stmt in body:
            for n in ast.walk(stmt):
                if n is node:
                    return True
        return False


def build_cfg(fn: ast.FunctionDef) -> CFG:
    """CFG of one (sync or async) function definition."""
    return _Builder().build(fn)


def function_defs(tree: ast.AST):
    """Every (possibly nested / method) function def in the module."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node
