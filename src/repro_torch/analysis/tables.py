"""The machine-readable API tables the rules check against.

Port of ``repro.analysis.tables``. The R, A and O tables are the
reference's: they match by path suffix and method name, and the port's
files keep the reference's. The L tables are keyed to ``src/repro_torch``
and ``chip_smoke.py``; the K tables describe the port's ctypes bindings
of its CUDA kernels.

This is the single place where the repo's resource-lifecycle and
layering conventions are written down as data: which calls/stores
acquire a slot, draft row, or prefix pin; which calls release them;
which attributes are loop-shared mutable state; which calls block an
event loop. Rules interpret these tables -- adding a new resource or a
new blocking call is a table edit, not a new rule.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Callable, Optional, Sequence, Tuple

# --------------------------------------------------------------- matchers --
# A site matcher is a predicate over one *statement*: it answers whether
# the statement contains the acquire / release / handoff action.


def _own_nodes(stmt: ast.stmt):
    """Walk a statement's own expressions WITHOUT descending into nested
    statements: a compound statement (if/for/while/try/with) matches only
    on its header, since the statements in its body are separate CFG
    nodes matched individually."""
    stack: list = [stmt]
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if not isinstance(child, ast.stmt):
                stack.append(child)


def _calls(stmt: ast.stmt):
    for n in _own_nodes(stmt):
        if isinstance(n, ast.Call):
            yield n


def call_named(*names: str) -> Callable[[ast.stmt], bool]:
    """A call whose callee is ``name(...)`` or ``<expr>.name(...)``."""
    def match(stmt: ast.stmt) -> bool:
        for c in _calls(stmt):
            f = c.func
            if isinstance(f, ast.Name) and f.id in names:
                return True
            if isinstance(f, ast.Attribute) and f.attr in names:
                return True
        return False
    return match


def method_on(attr: str, *methods: str) -> Callable[[ast.stmt], bool]:
    """A call ``<expr>.<attr>.<method>(...)``, e.g. _streams.pop(...)."""
    def match(stmt: ast.stmt) -> bool:
        for c in _calls(stmt):
            f = c.func
            if (isinstance(f, ast.Attribute) and f.attr in methods
                    and isinstance(f.value, ast.Attribute)
                    and f.value.attr == attr):
                return True
        return False
    return match


def store_subscript(attr: str,
                    value_none: Optional[bool] = None
                    ) -> Callable[[ast.stmt], bool]:
    """An assignment ``<expr>.<attr>[k] = v`` (optionally requiring v to
    be / not be ``None``), or ``del <expr>.<attr>[k]``."""
    def match(stmt: ast.stmt) -> bool:
        targets: Sequence[ast.expr] = ()
        value: Optional[ast.expr] = None
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AugAssign):
            targets, value = (stmt.target,), stmt.value
        elif isinstance(stmt, ast.Delete):
            targets = stmt.targets
        for t in targets:
            if (isinstance(t, ast.Subscript)
                    and isinstance(t.value, ast.Attribute)
                    and t.value.attr == attr):
                if value_none is None or isinstance(stmt, ast.Delete):
                    return True
                is_none = (isinstance(value, ast.Constant)
                           and value.value is None)
                if is_none == value_none:
                    return True
        return False
    return match


def store_attr(attr: str,
               value_none: Optional[bool] = None
               ) -> Callable[[ast.stmt], bool]:
    """An assignment ``<expr>.<attr> = v`` (optionally v is/isn't None)."""
    def match(stmt: ast.stmt) -> bool:
        if not isinstance(stmt, ast.Assign):
            return False
        for t in stmt.targets:
            if isinstance(t, ast.Attribute) and t.attr == attr:
                if value_none is None:
                    return True
                is_none = (isinstance(stmt.value, ast.Constant)
                           and stmt.value.value is None)
                if is_none == value_none:
                    return True
        return False
    return match


def del_subscript(attr: str) -> Callable[[ast.stmt], bool]:
    """A ``del <expr>.<attr>[k]`` statement."""
    def match(stmt: ast.stmt) -> bool:
        if not isinstance(stmt, ast.Delete):
            return False
        for t in stmt.targets:
            if (isinstance(t, ast.Subscript)
                    and isinstance(t.value, ast.Attribute)
                    and t.value.attr == attr):
                return True
        return False
    return match


def any_of(*matchers) -> Callable[[ast.stmt], bool]:
    def match(stmt: ast.stmt) -> bool:
        return any(m(stmt) for m in matchers)
    return match


# ------------------------------------------------------------- R: resources --
@dataclasses.dataclass
class Resource:
    """One tracked resource kind for the R-rules.

    ``acquire`` marks the acquire site; every CFG path through an
    acquire (function entry -> acquire -> exit) must touch a ``release``
    or ``handoff`` site -- ``handoff`` marks ownership transfer into
    long-lived engine/server state that a later release function frees.
    ``exempt_functions`` are the release functions themselves (their
    internal stores must not count as acquires). ``module_pairing``
    relaxes the per-function CFG walk to "the module must contain at
    least one release site" for resources acquired and released in
    different functions by design.
    """
    rid: str
    description: str
    path_suffixes: Tuple[str, ...]
    acquire: Callable[[ast.stmt], bool]
    release: Callable[[ast.stmt], bool]
    handoff: Optional[Callable[[ast.stmt], bool]] = None
    exempt_functions: Tuple[str, ...] = ()
    module_pairing: bool = False


RESOURCES = [
    Resource(
        rid="slot",
        description="engine KV slot (Engine._free_slot -> slot_req bind, "
                    "freed by Engine._release_request)",
        path_suffixes=("core/serving/engine.py",),
        acquire=call_named("_free_slot"),
        release=call_named("_release_request"),
        handoff=store_subscript("slot_req", value_none=False),
    ),
    Resource(
        rid="prefix_pin",
        description="prefix-cache pin (pin-count increment + "
                    "Request._prefix_pin bind, freed by _release_request)",
        path_suffixes=("core/serving/engine.py",),
        acquire=store_subscript("_prefix_pins"),
        release=any_of(call_named("_release_request"),
                       method_on("_prefix_pins", "pop")),
        handoff=store_attr("_prefix_pin", value_none=False),
        # complete_export decrements a TICKET-owned pin: it is a release
        # function for migration state, like _release_request
        exempt_functions=("_release_request", "complete_export"),
    ),
    Resource(
        rid="migration_export",
        description="KV-migration export ticket (_exports bind pins the "
                    "source slot + request, released by complete_export/"
                    "cancel_export popping the ticket)",
        path_suffixes=("core/serving/engine.py",),
        acquire=store_subscript("_exports", value_none=False),
        release=method_on("_exports", "pop"),
        # the export pin is BORN to outlive its function: export_kv pins,
        # a sibling imports, complete/cancel_export release -- pairing is
        # a module property, enforced per-action by R001 below
        module_pairing=True,
    ),
    Resource(
        rid="retired_request",
        description="request retirement (finished/aborted append must be "
                    "paired with Engine._release_request on the same path)",
        path_suffixes=("core/serving/engine.py",),
        acquire=method_on("finished", "append"),
        release=call_named("_release_request"),
    ),
    Resource(
        rid="aborted_request",
        description="request abort (aborted append must be paired with "
                    "Engine._release_request on the same path)",
        path_suffixes=("core/serving/engine.py",),
        acquire=method_on("aborted", "append"),
        release=call_named("_release_request"),
    ),
    Resource(
        rid="stream",
        description="server TokenStream registration (_streams bind, "
                    "released by pop/del in abort/_drain/_fail)",
        path_suffixes=("serving/server.py",),
        acquire=store_subscript("_streams", value_none=False),
        release=any_of(method_on("_streams", "pop"),
                       del_subscript("_streams")),
        module_pairing=True,
    ),
    Resource(
        rid="router_inflight",
        description="router inflight assignment (Replica.inflight bind, "
                    "released by inflight.pop on retire/cancel/redispatch)",
        path_suffixes=("cluster/router.py",),
        acquire=store_subscript("inflight", value_none=False),
        release=method_on("inflight", "pop"),
        module_pairing=True,
    ),
    Resource(
        rid="admission_waiter",
        description="admission-gate waiter (deferred-queue append, "
                    "released by remove/popleft)",
        path_suffixes=("serving/admission.py",),
        acquire=method_on("_waiters", "append"),
        release=any_of(method_on("_waiters", "remove"),
                       method_on("_waiters", "popleft")),
        module_pairing=True,
    ),
    Resource(
        rid="control_override",
        description="controller preset override (_overrides bind records "
                    "a deferred request's preferred fields, consumed by "
                    "commit or restored by revert -- no request stays "
                    "permanently downgraded after pressure clears)",
        path_suffixes=("control/controller.py",),
        acquire=store_subscript("_overrides", value_none=False),
        release=method_on("_overrides", "pop"),
        # _apply_fields acquires; the server's _admit resolution paths
        # release via commit()/revert() -- pairing is a module property,
        # with the specific release actions pinned per-function by R001
        module_pairing=True,
    ),
]


# R001: canonical release functions must contain EVERY release action of
# the resources they free -- deleting any single one is a finding.
@dataclasses.dataclass
class ReleaseAction:
    name: str
    matcher: Callable[[ast.stmt], bool]


RELEASE_COMPLETENESS = {
    ("core/serving/engine.py", "_release_request"): [
        ReleaseAction("slot-unbind (slot_req[slot] = None)",
                      store_subscript("slot_req", value_none=True)),
        ReleaseAction("draft-row release (decoder release_slot hook)",
                      call_named("release", "release_slot")),
        ReleaseAction("prefix-pin decrement/pop (_prefix_pins)",
                      any_of(method_on("_prefix_pins", "pop"),
                             store_subscript("_prefix_pins"))),
        ReleaseAction("prefix-pin clear (request._prefix_pin = None)",
                      store_attr("_prefix_pin", value_none=True)),
    ],
    ("serving/server.py", "abort"): [
        ReleaseAction("engine abort (frees slot/draft row/gamma/pin)",
                      method_on("engine", "abort")),
        ReleaseAction("stream deregistration (_streams.pop)",
                      method_on("_streams", "pop")),
        ReleaseAction("admission drain (freed capacity wakes waiters)",
                      method_on("admission", "maybe_admit")),
    ],
    ("core/serving/engine.py", "complete_export"): [
        ReleaseAction("export-ticket pop (_exports.pop)",
                      method_on("_exports", "pop")),
        ReleaseAction("running-list removal (running.remove)",
                      method_on("running", "remove")),
        ReleaseAction("source-slot unbind (slot_req[slot] = None)",
                      store_subscript("slot_req", value_none=True)),
        ReleaseAction("ticket prefix-pin decrement/pop (_prefix_pins)",
                      any_of(method_on("_prefix_pins", "pop"),
                             store_subscript("_prefix_pins"))),
    ],
    ("cluster/router.py", "_retire"): [
        ReleaseAction("router stream deregistration (_streams.pop)",
                      method_on("_streams", "pop")),
        ReleaseAction("replica inflight release (inflight.pop)",
                      method_on("inflight", "pop")),
    ],
    # repro.obs span lifecycle: the engine opens the per-request trace
    # span in submit() and MUST close it -- step() at retire, abort()
    # for everything else. Deleting either close orphans every span the
    # Perfetto export renders (O-rules check reachability; these two
    # entries make the specific close calls deletion-proof like any
    # other release action).
    ("core/serving/engine.py", "abort"): [
        ReleaseAction("trace span close on abort (tracer.span_abort)",
                      call_named("span_abort")),
    ],
    ("core/serving/engine.py", "step"): [
        ReleaseAction("request-span close at retire (tracer.span_end)",
                      call_named("span_end")),
    ],
    # repro.control override lifecycle: revert() must restore EVERY field
    # the controller rewrote -- deleting any single restore leaves a
    # request permanently degraded after pressure clears (the bug class
    # this R-table entry exists to make deletion-proof).
    ("control/controller.py", "revert"): [
        ReleaseAction("preferred-compression restore (req.compression)",
                      store_attr("compression", value_none=None)),
        ReleaseAction("preferred-decoder restore (req.decoder)",
                      store_attr("decoder", value_none=None)),
        ReleaseAction("stamped-count invalidation (nv_compressed = None)",
                      store_attr("nv_compressed", value_none=True)),
        ReleaseAction("override-record pop (_overrides.pop)",
                      method_on("_overrides", "pop")),
    ],
    ("control/controller.py", "commit"): [
        ReleaseAction("override-record pop (_overrides.pop)",
                      method_on("_overrides", "pop")),
    ],
}


# ------------------------------------------------------- O: tracing tables --
# repro.obs emission calls. Every ``span_begin`` must reach a matching
# ``span_end``/``span_abort``; the other emissions are one-shot.
SPAN_BEGIN_CALLS = ("span_begin",)
SPAN_CLOSE_CALLS = ("span_end", "span_abort")


@dataclasses.dataclass
class SpanScope:
    """Where the O001 span-pairing walk applies and in which mode.

    ``module_pairing=False`` runs the per-function CFG walk (every path
    begin -> function exit must cross a close site); ``True`` relaxes to
    "the module must contain at least one close site" for files whose
    spans open and close in different functions by design (the engine:
    ``submit`` opens the request span, ``step``/``abort`` close it).
    """
    path_suffix: str
    module_pairing: bool
    description: str


SPAN_SCOPES = [
    SpanScope("core/serving/engine.py", True,
              "request/prefill/kv_migration spans cross method "
              "boundaries; pairing is a module property, with the "
              "specific closes pinned per-function by R001"),
    SpanScope("serving/server.py", False,
              "admission_wait spans open and close inside one "
              "coroutine on every path, including cancellation"),
]

# repro.obs.profile hot-path sites (O003). Unlike trace spans, profiler
# sites NEVER cross a function boundary -- wall time is measured around a
# synchronous region -- so every scope runs the per-function CFG walk.
PROFILE_BEGIN_CALLS = ("site_begin",)
PROFILE_CLOSE_CALLS = ("site_end",)

PROFILE_SCOPES = [
    SpanScope("core/serving/engine.py", False,
              "profiler sites (prefill_forward, decode launch, compress, "
              "kv transfer, prefix tier, engine.step, model calls, "
              "sampling) open and close inside one method on every path"),
    SpanScope("control/controller.py", False,
              "the control_step site opens and closes inside "
              "Controller.on_step on every path"),
    SpanScope("models/transformer.py", False,
              "the model.head site opens and closes inside Model._head "
              "on every path (the layer sites are laps: no pair)"),
    SpanScope("serving/server.py", False,
              "the server.fan_out site opens and closes inside "
              "AsyncLVLMServer._drain on every path"),
]

# ---------------------------------------------------------- A: async tables --
# Blocking calls that stall the event loop when issued inside async def.
BLOCKING_CALLS = {
    ("time", "sleep"), ("os", "system"), ("subprocess", "run"),
    ("subprocess", "call"), ("subprocess", "check_call"),
    ("subprocess", "check_output"), ("socket", "create_connection"),
    ("requests", "get"), ("requests", "post"), ("urllib.request", "urlopen"),
}

# Shared mutable serving/cluster/engine state: a read-before-await plus
# write-after-await of one of these in a single async function is an
# interleaving hazard unless fenced with `# analysis: atomic-step`.
SHARED_STATE_ATTRS = {
    "_streams", "_waiters", "_draining", "inflight", "_prefix",
    "_prefix_pins", "waiting", "running", "slot_req",
}

# Mutating method names that count as writes on those attributes.
MUTATING_METHODS = {
    "append", "remove", "pop", "popleft", "appendleft", "clear", "update",
    "extend", "insert", "add", "discard", "move_to_end", "setdefault",
}

# ------------------------------------------------------- L: layering tables --
# Paths (relative to the repo root) that form the internal layer:
# repro_torch.core imports are allowed only here. ``chip_smoke.py`` sits
# beside ``tests/``: it is the port's test on the card, and it holds
# kernels and engines against internals, as the tests do.
INTERNAL_IMPORT_OK_PREFIXES = ("src/repro_torch/", "tests/", "chip_smoke.py")

# The facade layer allowed to touch EngineConfig.compression.
COMPRESSION_MUTATION_OK_PREFIXES = ("src/repro_torch/api/",
                                    "src/repro_torch/core/")

# Engine construction stays behind the facade outside the port's package.
ENGINE_CONSTRUCTION_OK_PREFIXES = ("src/repro_torch/", "tests/",
                                   "chip_smoke.py")

# ------------------------------------------------------- K: kernel tables --
# The kernel wrappers: each binds ``build.load("<lib>").<symbol>`` of
# ``csrc/<lib>.cu`` beside it with ctypes.
KERNEL_WRAPPER_PREFIX = "src/repro_torch/kernels/"
KERNEL_SOURCE_DIR = "csrc"

# C parameter type (``const`` dropped) -> the ctypes name that passes it.
# A pointer ``T*`` takes ``c_void_p`` or ``POINTER(<ctypes of T>)``.
CTYPES_OF_C = {
    "int": "c_int",
    "float": "c_float",
    "long long": "c_longlong",
    "void": "None",          # a return type only
}

# Module-level tables of the shapes a wrapper admits, and which entries of
# each row are the values its library's ``<lib>_smem_bytes(int dtype,
# int X[, int Y])`` dispatches on (None: the row is that value; an int:
# that entry; a tuple: those entries, in the function's order).
ADMITTED_SHAPE_TABLES = {
    "HEAD_DIMS": None,         # flash, paged: head dim D
    "SHAPES": 0,               # latent: (R, Rr) pairs, dispatched on R
    "HEAD_DIM_PAIRS": (0, 1),  # flash forward: (D, Dv) pairs
}

# The ``extern "C"`` function of every library that answers, for one
# (dtype, X), the shared memory of the instantiation it launches or -1
# when there is none: its ``X == <literal>`` cases are the shapes the
# library instantiates.
SMEM_FUNCTION_SUFFIX = "_smem_bytes"
