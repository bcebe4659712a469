"""Determinism checkers (RL10x): the invariants behind bit-exact replay.

Every differential gate in this repo (engine vs oracle, chunked vs
one-shot PCG64 streams, delta-splice vs full replay) assumes the code
under test is a pure function of ``(instance, seed)``. These rules make
that assumption a static property:

- ``global-rng``     (RL101): no ``np.random.*`` / stdlib ``random.*``
  module-level RNG anywhere — randomness must flow through a threaded,
  seeded ``Generator``. PyTorch's global generator likewise:
  ``torch.rand*``/``randn*``/``randint*``/``randperm``/``normal``/
  ``bernoulli``/``multinomial``/``poisson`` and the in-place random
  fills (``uniform_``, ``normal_``, ``nn.init``'s, …) without a
  ``generator=``, and ``torch.manual_seed``/``torch.cuda.manual_seed*``
  (seeding the global stream makes every later draw depend on it).
- ``unseeded-rng``   (RL102): ``default_rng()`` / ``PCG64()`` /
  ``random.Random()`` without a seed is nondeterministic across runs;
  so are ``torch.seed()``/``torch.cuda.seed*()`` and
  ``Generator.seed()``, which reseed from a nondeterministic source.
- ``wall-clock``     (RL103): ``time.time()`` / ``datetime.now()`` in
  scheduling code (core/, service/, kernels/, obs/) makes schedules
  depend on the host clock. ``perf_counter``/``monotonic`` are likewise
  findings everywhere except the one sanctioned boundary,
  ``repro_torch/obs/clock.py`` — telemetry may time, but only through that
  choke point, so "timing never feeds a scheduling decision" stays a
  one-grep audit.
- ``unordered-iteration`` (RL104): iterating a ``set`` (loops,
  comprehensions, ``sum``) feeds order-sensitive accumulation with an
  unordered container; dict iteration is insertion-ordered and exempt.
- ``float-eq``       (RL105): raw float ``==``/``!=`` outside the
  blessed exact-float oracle modules (``circuit_scheduler``/``online``,
  whose docstrings define the convention). Float-ness also covers torch
  tensors: a constructor with a float dtype or the default one
  (``zeros``, ``rand``, ``linspace``, …), ``.double()``/``.float()``,
  ``dtype=torch.float32/float64`` and ``.to(<float dtype>)``; and
  ``torch.eq``/``torch.ne`` (or ``.eq``/``.ne``) on such operands are the
  same comparison.
- ``commit-mutation`` (RL106): in-place mutation of committed
  ``FlowTable``/``FlatAssignState``/``ComponentIndex`` arrays outside
  their owning module breaks the immutability the tick-commit rule (and
  the index's partition-exactness contract) relies on. Torch's in-place
  methods (the trailing-underscore family: ``copy_``, ``fill_``,
  ``zero_``, ``index_put_``, ``masked_fill_``, ``scatter_``, ``add_``, …)
  and ``torch.<op>_(x, ...)`` count as such writes. The port keeps
  ``ComponentIndex`` (with ``FabricState``) in ``core/fabric.py``, so
  that is its owner here, where the reference names ``core/engine.py``.
"""
from __future__ import annotations

import ast
from typing import Iterator

from .common import Finding, Module, dotted_name, parse_annotation

__all__ = ["check_determinism"]

_RNG_OK = {"default_rng", "Generator", "PCG64", "SeedSequence",
           "BitGenerator", "Philox", "bit_generator"}
_STDLIB_RNG_OK = {"Random", "SystemRandom"}
_SEEDED_CTORS = {"numpy.random.default_rng", "numpy.random.PCG64",
                 "numpy.random.SeedSequence", "random.Random"}
_WALL_CLOCK = {"time.time", "time.time_ns", "time.ctime", "time.localtime",
               "time.gmtime", "datetime.datetime.now",
               "datetime.datetime.utcnow", "datetime.datetime.today",
               "datetime.date.today"}
# telemetry clocks: legal ONLY inside the sanctioned boundary module
_PERF_CLOCK = {"time.perf_counter", "time.perf_counter_ns",
               "time.monotonic", "time.monotonic_ns"}
_SANCTIONED_CLOCK_MODULE = "repro_torch/obs/clock.py"
# committed-state class -> its owning module (basename under
# repro_torch/core/)
_OWNER_FILES = {"FlowTable": "engine.py", "FlatAssignState": "assignment.py",
                "ComponentIndex": "fabric.py"}
_ARRAY_MUTATORS = {"fill", "sort", "put", "itemset", "resize", "setflags"}

# torch's global generator: samplers that take ``generator=`` and draw from
# the global one without it (the ``*_like`` ones take none at all)
_TORCH_SAMPLERS = {"rand", "rand_like", "randn", "randn_like", "randint",
                   "randint_like", "randperm", "normal", "bernoulli",
                   "multinomial", "poisson"}
# in-place random fills (tensor methods and ``torch.nn.init``)
_TORCH_RANDOM_FILLS = {"uniform_", "normal_", "bernoulli_", "random_",
                       "exponential_", "geometric_", "cauchy_", "log_normal_",
                       "trunc_normal_", "kaiming_uniform_", "kaiming_normal_",
                       "xavier_uniform_", "xavier_normal_", "orthogonal_",
                       "sparse_"}
_TORCH_GLOBAL_SEED = {"torch.manual_seed", "torch.random.manual_seed",
                      "torch.cuda.manual_seed", "torch.cuda.manual_seed_all"}
_TORCH_UNSEEDED = {"torch.seed", "torch.random.seed", "torch.cuda.seed",
                   "torch.cuda.seed_all"}
# blessed exact-float modules: their docstrings define the convention
_FLOAT_EQ_BLESSED = {"circuit_scheduler.py", "online.py"}

_FLOAT_ARRAY_CTORS = {"zeros", "ones", "full", "empty", "zeros_like",
                      "ones_like", "full_like", "linspace", "geomspace"}
_FLOAT_PRESERVING = {"maximum", "minimum", "where", "concatenate", "cumsum",
                     "sort", "clip", "abs", "add", "subtract", "multiply",
                     "divide", "min", "max", "sum", "asarray", "array",
                     "nextafter", "diff", "round", "copy", "ascontiguousarray"}
_FLOAT_METHODS = {"max", "min", "sum", "copy", "item", "mean", "cumsum",
                  "clip", "round", "take",
                  # torch: the tensor itself, moved or copied
                  "clone", "detach", "cpu", "contiguous", "numpy"}

# torch constructors whose dtype, unless given, is the default float one
_TORCH_FLOAT_CTORS = {"zeros", "ones", "empty", "rand", "randn", "linspace",
                      "logspace", "eye", "empty_strided"}
# torch functions whose result is float when an operand is
_TORCH_FLOAT_PRESERVING = _FLOAT_PRESERVING | {
    "cat", "stack", "clamp", "tensor", "as_tensor", "from_numpy",
    "zeros_like", "ones_like", "empty_like", "full_like", "full", "arange",
    "amax", "amin", "sqrt", "exp", "log"}
_TORCH_FLOAT_CASTS = {"double", "float", "half", "bfloat16"}
_TORCH_FLOAT_DTYPES = {"torch.float16", "torch.float32", "torch.float64",
                       "torch.bfloat16", "torch.float", "torch.double",
                       "torch.half"}
_TORCH_EQ = {"torch.eq", "torch.ne", "torch.not_equal"}


def check_determinism(mod: Module) -> Iterator[Finding]:
    yield from _check_rng(mod)
    if (mod.scheduling_scope or mod.is_obs) and \
            not mod.logical.endswith(_SANCTIONED_CLOCK_MODULE):
        yield from _check_wall_clock(mod)
    if mod.scheduling_scope:
        yield from _check_set_iteration(mod)
    if (mod.is_core or mod.is_service) and (
            not mod.is_core or mod.basename not in _FLOAT_EQ_BLESSED):
        yield from _check_float_eq(mod)
    yield from _check_commit_mutation(mod)


# ---------------------------------------------------------------- RNG rules

def _check_rng(mod: Module) -> Iterator[Finding]:
    seen: set[tuple[int, int]] = set()
    for node in ast.walk(mod.tree):
        if not isinstance(node, (ast.Attribute, ast.Name)):
            continue
        dotted = dotted_name(node, mod.aliases)
        if dotted is None or (node.lineno, node.col_offset) in seen:
            continue
        if dotted.startswith("numpy.random."):
            leaf = dotted.rsplit(".", 1)[1]
            if leaf not in _RNG_OK and leaf != "random":
                seen.add((node.lineno, node.col_offset))
                yield Finding(
                    "global-rng", str(mod.path), node.lineno,
                    node.col_offset,
                    f"global numpy RNG `{dotted}`: thread a seeded "
                    f"`np.random.Generator` instead")
        elif dotted.startswith("random.") and dotted.count(".") == 1:
            leaf = dotted.rsplit(".", 1)[1]
            if leaf not in _STDLIB_RNG_OK:
                seen.add((node.lineno, node.col_offset))
                yield Finding(
                    "global-rng", str(mod.path), node.lineno,
                    node.col_offset,
                    f"global stdlib RNG `{dotted}`: use a seeded "
                    f"`random.Random(seed)` or numpy Generator")
    generators = _torch_generator_names(mod)
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = dotted_name(node.func, mod.aliases)
        if dotted in _SEEDED_CTORS and not node.args and not node.keywords:
            yield Finding(
                "unseeded-rng", str(mod.path), node.lineno, node.col_offset,
                f"`{dotted}()` without a seed is nondeterministic across "
                f"runs; pass an explicit seed or SeedSequence")
        yield from _check_torch_rng(mod, node, dotted, generators)


def _torch_generator_names(mod: Module) -> set[str]:
    """Names bound to a ``torch.Generator`` anywhere in the module
    (assigned one, or annotated as one)."""
    out: set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Assign) and _is_torch_generator(
                node.value, mod):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.arg) and node.annotation is not None \
                and dotted_name(node.annotation, mod.aliases) \
                == "torch.Generator":
            out.add(node.arg)
    return out


def _is_torch_generator(node: ast.expr, mod: Module) -> bool:
    """``torch.Generator(...)``, possibly ``.manual_seed(s)`` on it."""
    while isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "manual_seed":
        node = node.func.value
    return isinstance(node, ast.Call) and dotted_name(
        node.func, mod.aliases) == "torch.Generator"


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


def _check_torch_rng(mod: Module, node: ast.Call, dotted: str | None,
                     generators: set[str]) -> Iterator[Finding]:
    f = node.func
    if dotted in _TORCH_GLOBAL_SEED:
        yield Finding(
            "global-rng", str(mod.path), node.lineno, node.col_offset,
            f"`{dotted}()` seeds torch's global generator: thread a seeded "
            f"`torch.Generator` instead")
    elif dotted in _TORCH_UNSEEDED:
        yield Finding(
            "unseeded-rng", str(mod.path), node.lineno, node.col_offset,
            f"`{dotted}()` reseeds torch's generator nondeterministically; "
            f"use `manual_seed(seed)` on a `torch.Generator`")
    elif dotted is not None and dotted.startswith("torch.") \
            and dotted.count(".") == 1 \
            and dotted.rsplit(".", 1)[1] in _TORCH_SAMPLERS \
            and not _has_generator(node):
        yield Finding(
            "global-rng", str(mod.path), node.lineno, node.col_offset,
            f"`{dotted}` draws from torch's global generator: pass "
            f"`generator=` a seeded `torch.Generator`")
    elif isinstance(f, ast.Attribute) and f.attr in _TORCH_RANDOM_FILLS \
            and not _has_generator(node):
        yield Finding(
            "global-rng", str(mod.path), node.lineno, node.col_offset,
            f"in-place random fill `.{f.attr}()` draws from torch's global "
            f"generator: pass `generator=` a seeded `torch.Generator`")
    elif isinstance(f, ast.Attribute) and f.attr == "seed" \
            and not node.args and not node.keywords and (
                _is_torch_generator(f.value, mod)
                or (isinstance(f.value, ast.Name)
                    and f.value.id in generators)):
        yield Finding(
            "unseeded-rng", str(mod.path), node.lineno, node.col_offset,
            "`Generator.seed()` reseeds from a nondeterministic source; "
            "use `manual_seed(seed)`")


def _check_wall_clock(mod: Module) -> Iterator[Finding]:
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = dotted_name(node.func, mod.aliases)
        if dotted in _WALL_CLOCK:
            yield Finding(
                "wall-clock", str(mod.path), node.lineno, node.col_offset,
                f"`{dotted}()` in scheduling code: schedules must be pure in "
                f"(instance, seed); route telemetry timing through "
                f"repro_torch.obs.clock")
        elif dotted in _PERF_CLOCK:
            yield Finding(
                "wall-clock", str(mod.path), node.lineno, node.col_offset,
                f"`{dotted}()` outside the sanctioned clock boundary: "
                f"telemetry timing must go through repro_torch.obs.clock.now() "
                f"so timing provably never feeds a scheduling decision")


# ------------------------------------------------------- set-iteration rule

def _scopes(tree: ast.Module) -> Iterator[
        tuple[ast.Module | ast.FunctionDef | ast.AsyncFunctionDef,
              list[ast.stmt]]]:
    """Yield (scope_node, body) for the module and every function def."""
    yield tree, tree.body
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node, node.body


def _walk_scope(body: list[ast.stmt]) -> Iterator[ast.AST]:
    """Walk a scope's statements without descending into nested defs.

    Nested functions are their own scope (own env, own params); yielding
    their innards here would double-report every finding and pollute the
    enclosing scope's type environment.
    """
    stack: list[ast.AST] = [s for s in reversed(body)
                            if not isinstance(s, (ast.FunctionDef,
                                                  ast.AsyncFunctionDef))]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            stack.append(child)


def _setish_vars(body: list[ast.stmt]) -> set[str]:
    """Names assigned a set-typed value anywhere in this scope (fixpoint)."""
    names: set[str] = set()
    for _ in range(3):
        before = len(names)
        for node in _walk_scope(body):
            targets: list[ast.expr] = []
            value: ast.expr | None = None
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value:
                targets, value = [node.target], node.value
            elif isinstance(node, ast.AugAssign):
                targets, value = [node.target], node.value
            if value is None or not _is_setish(value, names):
                continue
            for t in targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
        if len(names) == before:
            break
    return names


def _is_setish(node: ast.expr, names: set[str]) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Name):
        return node.id in names
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Name) and node.func.id in ("set",
                                                               "frozenset"):
            return True
        if isinstance(node.func, ast.Attribute):
            if node.func.attr in ("union", "intersection", "difference",
                                  "symmetric_difference", "copy"):
                return _is_setish(node.func.value, names)
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
        return (_is_setish(node.left, names)
                or _is_setish(node.right, names))
    return False


def _check_set_iteration(mod: Module) -> Iterator[Finding]:
    for scope, body in _scopes(mod.tree):
        names = _setish_vars(body)
        for node in _walk_scope(body):
            iters: list[ast.expr] = []
            if isinstance(node, ast.For):
                iters.append(node.iter)
            elif isinstance(node, (ast.ListComp, ast.SetComp,
                                   ast.DictComp, ast.GeneratorExp)):
                iters.extend(g.iter for g in node.generators)
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Name)
                  and node.func.id == "sum" and node.args):
                arg = node.args[0]
                if isinstance(arg, ast.GeneratorExp):
                    iters.extend(g.iter for g in arg.generators)
                else:
                    iters.append(arg)
            for it in iters:
                if _is_setish(it, names):
                    yield Finding(
                        "unordered-iteration", str(mod.path),
                        it.lineno, it.col_offset,
                        "iteration over a set feeds order-sensitive "
                        "accumulation; iterate a sorted() copy or an "
                        "insertion-ordered dict instead")


# ------------------------------------------------------------ float-eq rule

class _FloatEnv:
    """Tracks which local names are provably float-valued (scalar or array).

    Conservative: a name is floatish only when its value expression is
    provably float (float literal, float-dtype array constructor, an
    ``Annotated[F8, ...]`` parameter, arithmetic over floatish operands).
    Unknowns never flag — precision over recall; the differential suites
    still sample what this rule cannot prove.
    """

    def __init__(self, mod: Module) -> None:
        self.mod = mod
        self.names: set[str] = set()

    def seed_params(self, fn: ast.FunctionDef | ast.AsyncFunctionDef) -> None:
        args = list(fn.args.posonlyargs) + list(fn.args.args) + \
            list(fn.args.kwonlyargs)
        for a in args:
            info = parse_annotation(a.annotation)
            if info.kind == "scalar" and info.scalar == "float":
                self.names.add(a.arg)
            elif info.kind in ("array", "bare-array") and info.spec \
                    and info.spec.dtype == "f":
                self.names.add(a.arg)
        defaults = fn.args.defaults
        for a, d in zip(args[len(args) - len(defaults):], defaults):
            if isinstance(d, ast.Constant) and isinstance(d.value, float):
                self.names.add(a.arg)

    def propagate(self, body: list[ast.stmt]) -> None:
        for _ in range(3):
            before = len(self.names)
            for node in _walk_scope(body):
                targets: list[ast.expr] = []
                value: ast.expr | None = None
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, ast.AnnAssign):
                    info = parse_annotation(node.annotation)
                    if isinstance(node.target, ast.Name) and (
                            (info.kind == "scalar"
                             and info.scalar == "float")
                            or (info.kind == "array" and info.spec
                                and info.spec.dtype == "f")):
                        self.names.add(node.target.id)
                    continue
                elif isinstance(node, ast.AugAssign):
                    targets, value = [node.target], node.value
                elif isinstance(node, ast.For):
                    # `for t in <floatish array/list>` binds floats
                    if isinstance(node.target, ast.Name) and \
                            self.floatish(node.iter):
                        self.names.add(node.target.id)
                    continue
                if value is None or not self.floatish(value):
                    continue
                for t in targets:
                    if isinstance(t, ast.Name):
                        self.names.add(t.id)
                    elif isinstance(t, ast.Tuple):
                        for e in t.elts:
                            if isinstance(e, ast.Name):
                                self.names.add(e.id)
            if len(self.names) == before:
                break

    def floatish(self, node: ast.expr) -> bool:
        if isinstance(node, ast.Constant):
            return isinstance(node.value, float)
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Subscript):
            return self.floatish(node.value)
        if isinstance(node, ast.UnaryOp):
            return self.floatish(node.operand)
        if isinstance(node, ast.IfExp):
            return self.floatish(node.body) or self.floatish(node.orelse)
        if isinstance(node, ast.BinOp):
            if isinstance(node.op, (ast.Add, ast.Sub, ast.Mult, ast.Div,
                                    ast.FloorDiv, ast.Mod, ast.Pow)):
                if isinstance(node.op, ast.Div):
                    return True          # true division always yields float
                return self.floatish(node.left) or self.floatish(node.right)
            return False
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name):
                if f.id == "float":
                    return True
                if f.id in ("abs", "sum", "max", "min", "sorted") and \
                        node.args:
                    return self.floatish(node.args[0])
                return False
            if isinstance(f, ast.Attribute):
                dotted = dotted_name(f, self.mod.aliases)
                if dotted and dotted.startswith("numpy."):
                    leaf = dotted.rsplit(".", 1)[1]
                    if leaf in ("float64", "float32", "inf", "nan"):
                        return True
                    if leaf in _FLOAT_ARRAY_CTORS:
                        return not _has_nonfloat_dtype(node, self.mod)
                    if leaf in _FLOAT_PRESERVING:
                        return any(self.floatish(a) for a in node.args
                                   if isinstance(a, ast.expr))
                    return False
                if dotted and dotted.startswith("torch."):
                    return self._torch_floatish(node,
                                                dotted.rsplit(".", 1)[1])
                if f.attr in _FLOAT_METHODS:
                    return self.floatish(f.value)
                if f.attr == "astype":
                    return any(_is_float_dtype_expr(a, self.mod)
                               for a in node.args)
                if f.attr in _TORCH_FLOAT_CASTS and not node.args:
                    return True
                if f.attr == "to":
                    dtype = _dtype_kw(node)
                    if dtype is not None:
                        return _is_float_dtype_expr(dtype, self.mod)
                    if any(_is_float_dtype_expr(a, self.mod)
                           for a in node.args):
                        return True
                    return self.floatish(f.value)
            return False
        if isinstance(node, ast.Attribute):
            dotted = dotted_name(node, self.mod.aliases)
            return dotted in ("numpy.inf", "numpy.nan", "math.inf",
                              "math.nan", "torch.inf", "torch.nan")
        return False

    def _torch_floatish(self, node: ast.Call, leaf: str) -> bool:
        """``torch.<leaf>(...)``: float by its ``dtype=``, else by the
        default float dtype of a constructor, else by its operands."""
        dtype = _dtype_kw(node)
        if dtype is not None:
            return _is_float_dtype_expr(dtype, self.mod)
        if leaf in _TORCH_FLOAT_CTORS:
            return True
        if leaf in _TORCH_FLOAT_PRESERVING:
            return any(self.floatish(a) for a in node.args
                       if isinstance(a, ast.expr))
        return False


def _is_float_dtype_expr(node: ast.expr, mod: Module) -> bool:
    if isinstance(node, ast.Name) and node.id == "float":
        return True
    dotted = dotted_name(node, mod.aliases)
    return dotted in ("numpy.float64", "numpy.float32") \
        or dotted in _TORCH_FLOAT_DTYPES


def _dtype_kw(call: ast.Call) -> ast.expr | None:
    for kw in call.keywords:
        if kw.arg == "dtype":
            return kw.value
    return None


def _has_nonfloat_dtype(call: ast.Call, mod: Module) -> bool:
    for kw in call.keywords:
        if kw.arg == "dtype":
            return not _is_float_dtype_expr(kw.value, mod)
    return False


def _check_float_eq(mod: Module) -> Iterator[Finding]:
    for scope, body in _scopes(mod.tree):
        env = _FloatEnv(mod)
        if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
            env.seed_params(scope)
        env.propagate(body)
        for node in _walk_scope(body):
            if isinstance(node, ast.Call):
                yield from _torch_eq(mod, env, node)
                continue
            if not isinstance(node, ast.Compare):
                continue
            operands = [node.left] + list(node.comparators)
            for op, lhs, rhs in zip(node.ops, operands, operands[1:]):
                if not isinstance(op, (ast.Eq, ast.NotEq)):
                    continue
                if env.floatish(lhs) or env.floatish(rhs):
                    sym = "==" if isinstance(op, ast.Eq) else "!="
                    yield Finding(
                        "float-eq", str(mod.path), node.lineno,
                        node.col_offset,
                        f"raw float `{sym}` outside the blessed "
                        f"exact-float modules (circuit_scheduler/"
                        f"online); use an explicit tolerance or a "
                        f"justified suppression citing the exact-float "
                        f"convention")


def _torch_eq(mod: Module, env: _FloatEnv,
              node: ast.Call) -> Iterator[Finding]:
    """``torch.eq(a, b)``/``torch.ne(a, b)``, or ``a.eq(b)``/``a.ne(b)``,
    with a float operand: the same comparison as ``==``/``!=``."""
    f = node.func
    dotted = dotted_name(f, mod.aliases) if isinstance(
        f, (ast.Attribute, ast.Name)) else None
    if dotted in _TORCH_EQ:
        operands, what = list(node.args), dotted
    elif isinstance(f, ast.Attribute) and f.attr in ("eq", "ne") \
            and dotted is None:
        operands, what = [f.value, *node.args], f".{f.attr}()"
    else:
        return
    if any(env.floatish(a) for a in operands if isinstance(a, ast.expr)):
        yield Finding(
            "float-eq", str(mod.path), node.lineno, node.col_offset,
            f"raw float `{what}` outside the blessed exact-float modules "
            f"(circuit_scheduler/online); use an explicit tolerance or a "
            f"justified suppression citing the exact-float convention")


def is_inplace_method(name: str) -> bool:
    """A numpy in-place mutator, or torch's trailing-underscore family."""
    return name in _ARRAY_MUTATORS or (
        name.endswith("_") and not name.startswith("_"))


# ------------------------------------------------------ commit-mutation rule

def _committed_vars(mod: Module,
                    fn: ast.FunctionDef | ast.AsyncFunctionDef | None,
                    body: list[ast.stmt]) -> dict[str, str]:
    """Names bound to committed-state instances (``_OWNER_FILES`` classes:
    FlowTable / FlatAssignState / ComponentIndex) in this scope."""
    out: dict[str, str] = {}
    if fn is not None:
        for a in (list(fn.args.posonlyargs) + list(fn.args.args)
                  + list(fn.args.kwonlyargs)):
            info = parse_annotation(a.annotation)
            if info.kind == "class" and info.class_name in _OWNER_FILES:
                out[a.arg] = info.class_name
    for node in _walk_scope(body):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            f = node.value.func
            leaf = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else "")
            cls = ""
            if leaf in _OWNER_FILES:
                cls = leaf
            elif leaf == "from_assignment" and isinstance(f, ast.Attribute) \
                    and isinstance(f.value, ast.Name) \
                    and f.value.id in _OWNER_FILES:
                cls = f.value.id
            elif leaf == "build_flow_table":
                cls = "FlowTable"
            if cls:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = cls
    return out


def _check_commit_mutation(mod: Module) -> Iterator[Finding]:
    for scope, body in _scopes(mod.tree):
        fn = scope if isinstance(scope, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)) else None
        tracked = _committed_vars(mod, fn, body)
        if not tracked:
            continue
        for node in _walk_scope(body):
            yield from _mutations(mod, node, tracked)


def _owned_here(mod: Module, cls: str) -> bool:
    return mod.is_core and mod.basename == _OWNER_FILES[cls]


def _tracked_attr(node: ast.expr, tracked: dict[str, str]) -> str | None:
    """`x.field` where x is a tracked committed object -> class name."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
        return tracked.get(node.value.id)
    return None


def _mutations(mod: Module, node: ast.AST,
               tracked: dict[str, str]) -> Iterator[Finding]:
    def emit(n: ast.AST, cls: str, what: str) -> Iterator[Finding]:
        if _owned_here(mod, cls):
            return
        yield Finding(
            "commit-mutation", str(mod.path), n.lineno, n.col_offset,
            f"{what} of committed `{cls}` state outside its owning module "
            f"({_OWNER_FILES[cls]}); committed arrays are immutable — "
            f"rebuild or go through the owner's API")

    if isinstance(node, (ast.Assign, ast.AugAssign)):
        targets = node.targets if isinstance(node, ast.Assign) else \
            [node.target]
        for t in targets:
            cls = _tracked_attr(t, tracked)
            if cls:
                yield from emit(t, cls, "attribute rebinding")
            if isinstance(t, ast.Subscript):
                cls = _tracked_attr(t.value, tracked)
                if cls:
                    yield from emit(t, cls, "in-place array write")
    elif isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and is_inplace_method(f.attr):
            # x.field.copy_(...) and x.field[idx].copy_(...) alike
            base = f.value.value if isinstance(f.value, ast.Subscript) \
                else f.value
            cls = _tracked_attr(base, tracked)
            if cls:
                yield from emit(node, cls, f"in-place `.{f.attr}()`")
        dotted = dotted_name(f, mod.aliases) if isinstance(
            f, (ast.Attribute, ast.Name)) else None
        if dotted and node.args and (
                (dotted.startswith("numpy.") and dotted.endswith(".at"))
                or (dotted.startswith("torch.")
                    and is_inplace_method(dotted.rsplit(".", 1)[1]))):
            cls = _tracked_attr(node.args[0], tracked)
            if cls:
                yield from emit(node, cls, f"in-place `{dotted}`")
        for kw in node.keywords:
            if kw.arg == "out":
                cls = _tracked_attr(kw.value, tracked)
                if cls:
                    yield from emit(node, cls, "`out=` write")
