"""Array-contract checkers (RL20x): shape/dtype annotations + kernel rules.

The contract modules (``core/engine.py``, ``core/fabric.py``,
``core/assignment.py``, ``core/coflow.py``, every ``service/*.py``) carry
flat numpy arrays through their public signatures. These rules make the
shapes part of the reviewed source instead of tribal knowledge:

- ``contract-missing`` (RL201): public functions/methods in contract
  modules must annotate every parameter and the return; array-typed
  parameters must use ``Annotated[F8, "F"]``-style specs (see
  ``repro_torch.core.arrays``), and the spec string must parse.
- ``shape-mismatch``  (RL202): at call sites inside contract modules,
  when a passed argument is itself an annotated parameter of the caller,
  its declared rank must match the callee's declared rank, and one
  callee shape variable must not bind two different caller dims in the
  same call.
- ``kernel-fp64``     (RL203): inside Pallas kernel bodies (functions
  with ``*_ref`` params under ``kernels/``), no fp64 types and no host
  numpy — the kernels' precision contract says their state is fp32. The
  port's kernels are CUDA C++ (``kernels/csrc/*.cu`` and the ``*.cuh``
  headers they share): inside ``__global__`` and ``__device__``
  functions, no ``double``, no unsuffixed floating literal (``1.0`` is a
  double in C++) and no ``__d*`` double intrinsic (comments and literals
  are not read). The assignment kernels are bit-equal to ``assign_ref``
  only when no multiply-add is contracted, so ``kernels/_build.py``'s
  ``EXTRA_FLAGS`` must give ``-fmad=false`` to ``coflow_assign_sm90`` and
  ``coflow_assign_lanes_sm90``, and nothing may turn it back on (it also
  gives it to the fp32 attention kernel, ``flash_attention_fp32_sm90``,
  whose every operation is an explicitly rounded intrinsic besides).
- ``blockspec-shape`` (RL204): literal ``BlockSpec`` tiles must be
  positive and divide literal ``out_shape`` dims. For the CUDA kernels,
  the Python side and the source must agree on the tiles, and every tile
  is positive: ``kernels/coflow_assign.py``'s ``CHAIN_CHUNK`` and
  ``CHAIN_STAGES`` are ``kChunk`` and ``kStages`` of
  ``csrc/coflow_assign_sm90.cu``, its ``LANES_CHUNK``, ``LANES_STAGES``
  and ``LANES_PER_LANE`` are ``kChunk``, ``kStages`` and ``kMaxPerLane``
  of ``csrc/coflow_assign_lanes_sm90.cu``; ``kernels/flash_attention.py``'s
  ``HEAD_DIMS`` are the head dims each of its ``KERNELS`` instantiates
  (``launch<Dh>``), and its ``TILES[kernel][Dh]`` are that source's
  ``(kBlockQ, block_k(Dh))``, with ``block_q(Dh)`` where it has one and
  ``kBlockK`` where it has no ``block_k`` (the bf16 kernel
  ``flash_attention_sm90.cu``, the fp32 kernel
  ``flash_attention_fp32_sm90.cu``).
"""
from __future__ import annotations

import ast
from typing import Iterator

import re

from .common import (ArrSpec, CudaSource, Finding, FuncSpec, Module,
                     dotted_name, parse_annotation)

__all__ = ["is_contract_module", "build_registry", "check_contracts",
           "check_cuda", "check_kernel_pairs"]

# the reference's engine.py holds FabricState and ComponentIndex; the
# port's core/fabric.py does
_CONTRACT_CORE = {"engine.py", "fabric.py", "assignment.py", "coflow.py"}


def is_contract_module(mod: Module) -> bool:
    if mod.is_core and mod.basename in _CONTRACT_CORE:
        return True
    return mod.is_service and mod.basename != "__init__.py"


# ----------------------------------------------------------------- registry

def _func_spec(fn: ast.FunctionDef | ast.AsyncFunctionDef,
               qual: str) -> FuncSpec:
    params: list[str] = []
    specs: dict[str, ArrSpec] = {}
    for a in list(fn.args.posonlyargs) + list(fn.args.args):
        params.append(a.arg)
        info = parse_annotation(a.annotation)
        if info.kind == "array" and info.spec:
            specs[a.arg] = info.spec
    for a in fn.args.kwonlyargs:
        info = parse_annotation(a.annotation)
        if info.kind == "array" and info.spec:
            specs[a.arg] = info.spec
    return FuncSpec(qualname=qual, line=fn.lineno, params=params,
                    specs=specs, returns=parse_annotation(fn.returns))


def build_registry(modules: list[Module]) -> dict[str, dict[str, FuncSpec]]:
    """logical-path -> {qualname -> FuncSpec} over all contract modules."""
    registry: dict[str, dict[str, FuncSpec]] = {}
    for mod in modules:
        if not is_contract_module(mod):
            continue
        table: dict[str, FuncSpec] = {}
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                table[node.name] = _func_spec(node, node.name)
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        qual = f"{node.name}.{sub.name}"
                        table[qual] = _func_spec(sub, qual)
        registry[mod.logical] = table
    return registry


# --------------------------------------------------------- contract-missing

def _is_public(name: str) -> bool:
    return not name.startswith("_")


def _decorator_names(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> set[str]:
    out: set[str] = set()
    for d in fn.decorator_list:
        node = d.func if isinstance(d, ast.Call) else d
        if isinstance(node, ast.Attribute):
            out.add(node.attr)
        elif isinstance(node, ast.Name):
            out.add(node.id)
    return out


def _check_signature(mod: Module, fn: ast.FunctionDef | ast.AsyncFunctionDef,
                     qual: str) -> Iterator[Finding]:
    decorators = _decorator_names(fn)
    if "overload" in decorators:
        return
    args = list(fn.args.posonlyargs) + list(fn.args.args) + \
        list(fn.args.kwonlyargs)
    for i, a in enumerate(args):
        if i == 0 and a.arg in ("self", "cls"):
            continue
        info = parse_annotation(a.annotation)
        if info.kind == "missing":
            yield Finding(
                "contract-missing", str(mod.path), fn.lineno, fn.col_offset,
                f"`{qual}`: parameter `{a.arg}` is unannotated (contract "
                f"modules annotate every public signature)")
        elif info.kind == "bare-array":
            yield Finding(
                "contract-missing", str(mod.path), fn.lineno, fn.col_offset,
                f"`{qual}`: parameter `{a.arg}` is a bare array type; use "
                f"`Annotated[F8, \"<dims>\"]` from repro_torch.core.arrays")
        elif info.spec_error:
            yield Finding(
                "contract-missing", str(mod.path), fn.lineno, fn.col_offset,
                f"`{qual}`: parameter `{a.arg}`: {info.spec_error}")
    ret = parse_annotation(fn.returns)
    if ret.kind == "missing":
        yield Finding(
            "contract-missing", str(mod.path), fn.lineno, fn.col_offset,
            f"`{qual}`: missing return annotation (annotate `-> None` "
            f"explicitly when nothing is returned)")
    elif ret.kind == "bare-array":
        yield Finding(
            "contract-missing", str(mod.path), fn.lineno, fn.col_offset,
            f"`{qual}`: bare array return type; use "
            f"`Annotated[F8, \"<dims>\"]` from repro_torch.core.arrays")
    elif ret.spec_error:
        yield Finding(
            "contract-missing", str(mod.path), fn.lineno, fn.col_offset,
            f"`{qual}`: return annotation: {ret.spec_error}")


def _is_dunder(name: str) -> bool:
    return name.startswith("__") and name.endswith("__")


def _check_contract_missing(mod: Module) -> Iterator[Finding]:
    for node in mod.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if _is_public(node.name) and not _is_dunder(node.name):
                yield from _check_signature(mod, node, node.name)
        elif isinstance(node, ast.ClassDef) and _is_public(node.name):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and _is_public(sub.name) and not _is_dunder(sub.name):
                    yield from _check_signature(
                        mod, sub, f"{node.name}.{sub.name}")


# ----------------------------------------------------------- shape-mismatch

def _local_callables(mod: Module,
                     registry: dict[str, dict[str, FuncSpec]]
                     ) -> dict[str, FuncSpec]:
    """Callables resolvable by bare name in this module: same-module defs
    plus functions imported from other contract modules."""
    out: dict[str, FuncSpec] = {}
    for logical, table in registry.items():
        if logical == mod.logical:
            for qual, spec in table.items():
                if "." not in qual:
                    out[qual] = spec
    for name, target in mod.aliases.items():
        leaf = target.rsplit(".", 1)[-1]
        for logical, table in registry.items():
            if leaf in table and "." not in leaf:
                mod_path = target.rsplit(".", 1)[0].replace(".", "/")
                if logical.endswith(mod_path + ".py"):
                    out[name] = table[leaf]
    return out


def _enclosing_specs(fn: ast.FunctionDef | ast.AsyncFunctionDef
                     ) -> dict[str, ArrSpec]:
    specs: dict[str, ArrSpec] = {}
    for a in (list(fn.args.posonlyargs) + list(fn.args.args)
              + list(fn.args.kwonlyargs)):
        info = parse_annotation(a.annotation)
        if info.kind == "array" and info.spec:
            specs[a.arg] = info.spec
    return specs


def _check_shape_mismatch(mod: Module,
                          registry: dict[str, dict[str, FuncSpec]]
                          ) -> Iterator[Finding]:
    if mod.logical not in registry:
        return
    callables = _local_callables(mod, registry)
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        caller_specs = _enclosing_specs(fn)
        if not caller_specs:
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call) or \
                    not isinstance(node.func, ast.Name):
                continue
            callee = callables.get(node.func.id)
            if callee is None:
                continue
            bindings: dict[str, str] = {}   # callee dim var -> caller dim
            pairs: list[tuple[str, ast.expr]] = []
            offset = 1 if callee.params[:1] == ["self"] else 0
            for i, arg in enumerate(node.args):
                if i + offset < len(callee.params):
                    pairs.append((callee.params[i + offset], arg))
            for kw in node.keywords:
                if kw.arg:
                    pairs.append((kw.arg, kw.value))
            for pname, arg in pairs:
                callee_spec = callee.specs.get(pname)
                if callee_spec is None or not isinstance(arg, ast.Name):
                    continue
                caller_spec = caller_specs.get(arg.id)
                if caller_spec is None:
                    continue
                if callee_spec.ndim != caller_spec.ndim:
                    yield Finding(
                        "shape-mismatch", str(mod.path), node.lineno,
                        node.col_offset,
                        f"`{callee.qualname}({pname}=...)` declares rank "
                        f"{callee_spec.ndim} "
                        f"(\"{' '.join(callee_spec.dims)}\") but caller "
                        f"passes `{arg.id}` declared rank "
                        f"{caller_spec.ndim} "
                        f"(\"{' '.join(caller_spec.dims)}\")")
                    continue
                for cv, dv in zip(callee_spec.dims, caller_spec.dims):
                    if cv == "*" or dv == "*":
                        continue
                    if cv.isdigit() and dv.isdigit() and cv != dv:
                        yield Finding(
                            "shape-mismatch", str(mod.path), node.lineno,
                            node.col_offset,
                            f"`{callee.qualname}({pname}=...)`: literal dim "
                            f"{cv} != passed literal dim {dv}")
                        continue
                    if cv.isdigit() or dv.isdigit():
                        continue
                    seen = bindings.setdefault(cv, dv)
                    if seen != dv:
                        yield Finding(
                            "shape-mismatch", str(mod.path), node.lineno,
                            node.col_offset,
                            f"`{callee.qualname}`: shape variable `{cv}` "
                            f"bound to both `{seen}` and `{dv}` in one call")


# --------------------------------------------------------------- RL203/204

def _kernel_bodies(mod: Module) -> Iterator[
        ast.FunctionDef | ast.AsyncFunctionDef]:
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names = [a.arg for a in node.args.args + node.args.posonlyargs]
            if any(n.endswith("_ref") for n in names):
                yield node


def _check_kernel_fp64(mod: Module) -> Iterator[Finding]:
    for fn in _kernel_bodies(mod):
        for node in ast.walk(fn):
            if isinstance(node, ast.Attribute) and node.attr in (
                    "float64", "double"):
                yield Finding(
                    "kernel-fp64", str(mod.path), node.lineno,
                    node.col_offset,
                    "fp64 inside a Pallas kernel body: the kernel precision "
                    "contract is fp32; accumulate in float32")
            elif isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr == "astype":
                    if any(isinstance(a, ast.Name) and a.id == "float"
                           for a in node.args):
                        yield Finding(
                            "kernel-fp64", str(mod.path), node.lineno,
                            node.col_offset,
                            "`.astype(float)` promotes to fp64 inside a "
                            "Pallas kernel body; use jnp.float32")
                for kw in node.keywords:
                    if kw.arg == "dtype" and isinstance(kw.value, ast.Name) \
                            and kw.value.id == "float":
                        yield Finding(
                            "kernel-fp64", str(mod.path), node.lineno,
                            node.col_offset,
                            "`dtype=float` is fp64 inside a Pallas kernel "
                            "body; use jnp.float32")
        for node in ast.walk(fn):
            if isinstance(node, ast.Attribute) and node.attr in (
                    "float64", "double"):
                continue        # already reported by the fp64 check above
            dotted = dotted_name(node, mod.aliases) if isinstance(
                node, ast.Attribute) else None
            if dotted and dotted.startswith("numpy."):
                yield Finding(
                    "kernel-fp64", str(mod.path), node.lineno,
                    node.col_offset,
                    f"host numpy (`{dotted}`) inside a Pallas kernel body; "
                    f"kernels trace jnp/pl only (host numpy silently "
                    f"promotes to fp64)")


def _literal_tuple(node: ast.expr | None) -> tuple[int, ...] | None:
    if isinstance(node, ast.Tuple) and all(
            isinstance(e, ast.Constant) and isinstance(e.value, int)
            for e in node.elts):
        return tuple(e.value for e in node.elts)
    return None


def _blockspec_tiles(
        node: ast.expr) -> tuple[ast.Call, tuple[ast.expr, ...]] | None:
    if isinstance(node, ast.Call):
        f = node.func
        leaf = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else "")
        if leaf == "BlockSpec" and node.args:
            return node, (node.args[0],)
    return None


def _check_blockspec(mod: Module) -> Iterator[Finding]:
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        leaf = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else "")
        if leaf == "BlockSpec" and node.args:
            tiles = _literal_tuple(node.args[0])
            if tiles is not None and any(t <= 0 for t in tiles):
                yield Finding(
                    "blockspec-shape", str(mod.path), node.lineno,
                    node.col_offset,
                    f"BlockSpec tile {tiles} has a non-positive extent")
        if leaf == "pallas_call":
            yield from _check_pallas_call(mod, node)


def _check_pallas_call(mod: Module, call: ast.Call) -> Iterator[Finding]:
    out_shape: tuple[int, ...] | None = None
    out_tiles: tuple[int, ...] | None = None
    for kw in call.keywords:
        if kw.arg == "out_shape" and isinstance(kw.value, ast.Call):
            inner = kw.value
            leaf = (inner.func.attr if isinstance(inner.func, ast.Attribute)
                    else inner.func.id if isinstance(inner.func, ast.Name)
                    else "")
            if leaf == "ShapeDtypeStruct" and inner.args:
                out_shape = _literal_tuple(inner.args[0])
        if kw.arg == "out_specs":
            spec = _blockspec_tiles(kw.value)
            if spec is not None:
                out_tiles = _literal_tuple(spec[1][0])
    if out_shape is None or out_tiles is None:
        return
    if len(out_shape) != len(out_tiles):
        yield Finding(
            "blockspec-shape", str(mod.path), call.lineno, call.col_offset,
            f"out_specs tile rank {len(out_tiles)} != out_shape rank "
            f"{len(out_shape)}")
        return
    for dim, tile in zip(out_shape, out_tiles):
        if tile > 0 and dim % tile != 0:
            yield Finding(
                "blockspec-shape", str(mod.path), call.lineno,
                call.col_offset,
                f"BlockSpec tile {tile} does not divide out_shape dim "
                f"{dim}: the trailing block would read out of bounds")


# ------------------------------------------------------------------- driver

def check_contracts(mod: Module,
                    registry: dict[str, dict[str, FuncSpec]]
                    ) -> Iterator[Finding]:
    if is_contract_module(mod):
        yield from _check_contract_missing(mod)
        yield from _check_shape_mismatch(mod, registry)
    if mod.is_kernels:
        yield from _check_kernel_fp64(mod)
        yield from _check_blockspec(mod)
        if mod.basename == "_build.py":
            yield from _check_no_fma(mod)


# ---------------------------------------------------- RL203/204, CUDA side

#: Kernels bit-equal to ``assign_ref``: built without FMA contraction.
_NO_FMA_KERNELS = ("coflow_assign_sm90", "coflow_assign_lanes_sm90")
_FMA_ON = ("-fmad=true", "--fmad=true", "-use_fast_math", "--use_fast_math")
#: Launch-side tile constants and the kernel constants they must equal:
#: (module under kernels/, its constant, source under kernels/csrc/, its
#: constexpr).
_TILE_PAIRS = (
    ("coflow_assign.py", "CHAIN_CHUNK", "coflow_assign_sm90.cu", "kChunk"),
    ("coflow_assign.py", "CHAIN_STAGES", "coflow_assign_sm90.cu", "kStages"),
    ("coflow_assign.py", "LANES_CHUNK", "coflow_assign_lanes_sm90.cu",
     "kChunk"),
    ("coflow_assign.py", "LANES_STAGES", "coflow_assign_lanes_sm90.cu",
     "kStages"),
    ("coflow_assign.py", "LANES_PER_LANE", "coflow_assign_lanes_sm90.cu",
     "kMaxPerLane"),
)
#: Tile constexprs of the CUDA sources, each of which must be positive.
_TILE_NAMES = ("kChunk", "kStages", "kMaxPerLane", "kBlockQ", "kBlockK")

_DEVICE_FN = re.compile(r"\b__(?:global|device)__\b")
_DOUBLE = re.compile(r"\bdouble\b")
# a floating literal (a point or an exponent), with its suffix
_FLOAT_LIT = re.compile(
    r"(?<![\w.])((?:\d+\.\d*|\.\d+)(?:[eE][+-]?\d+)?|\d+[eE][+-]?\d+)"
    r"([fFlL]?)(?![\w.])")
_D_INTRINSIC = re.compile(r"\b(__d(?!evice__|p[24]a)\w*)\s*\(")
_CONSTEXPR = re.compile(
    r"\bconstexpr\s+(?:int|unsigned|uint32_t|long)\s+(\w+)\s*=\s*"
    r"([^;]+);")
_CONSTEXPR_FN = re.compile(
    r"\bconstexpr\s+int\s+(\w+)\s*\(\s*int\s+(\w+)\s*\)\s*\{\s*"
    r"return\s+([^;]+);\s*\}")
_LAUNCH_DH = re.compile(r"\blaunch<\s*(\d+)\s*>")


def _offsets(lines: list[str]) -> list[int]:
    out, at = [], 0
    for text in lines:
        out.append(at)
        at += len(text) + 1
    return out


def _where(starts: list[int], pos: int) -> tuple[int, int]:
    """(line, col) of flat offset ``pos``."""
    lo, hi = 0, len(starts) - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if starts[mid] <= pos:
            lo = mid
        else:
            hi = mid - 1
    return lo + 1, pos - starts[lo]


def _device_regions(code: str) -> list[tuple[int, int]]:
    """Spans of ``__global__``/``__device__`` functions, from the
    qualifier to the closing brace of the body (declarations and device
    variables have no body and give none)."""
    regions: list[tuple[int, int]] = []
    for m in _DEVICE_FN.finditer(code):
        if regions and m.start() < regions[-1][1]:
            continue
        depth, i = 0, m.end()
        while i < len(code) and not (depth == 0 and code[i] in "{;"):
            depth += {"(": 1, ")": -1}.get(code[i], 0)
            i += 1
        if i >= len(code) or code[i] == ";":
            continue
        braces = 0
        for j in range(i, len(code)):
            braces += {"{": 1, "}": -1}.get(code[j], 0)
            if braces == 0:
                regions.append((m.start(), j + 1))
                break
    return regions


def _cuda_fp64(src: CudaSource) -> Iterator[Finding]:
    code = "\n".join(src.code)
    starts = _offsets(src.code)
    for lo, hi in _device_regions(code):
        body = code[lo:hi]
        hits: list[tuple[int, str]] = []
        for m in _DOUBLE.finditer(body):
            hits.append((m.start(), "`double` in device code: the kernel "
                                    "precision contract is fp32"))
        for m in _FLOAT_LIT.finditer(body):
            if m.group(2) in ("f", "F"):
                continue
            hits.append((m.start(), f"floating literal `{m.group(0)}` without "
                                    f"an `f` suffix is a double in C++; "
                                    f"write `{m.group(1)}f`"))
        for m in _D_INTRINSIC.finditer(body):
            hits.append((m.start(), f"double intrinsic `{m.group(1)}` in "
                                    f"device code; use the fp32 one"))
        for pos, msg in sorted(hits):
            line, col = _where(starts, lo + pos)
            yield Finding("kernel-fp64", str(src.path), line, col, msg)


def _cuda_constants(src: CudaSource) -> tuple[dict[str, tuple[int, int]],
                                              dict[str, tuple[str, str]]]:
    """Namespace-level ``constexpr`` integers, ``name -> (value, line)``,
    and one-argument ``constexpr int`` functions, ``name -> (arg, expr)``;
    a constant whose expression does not evaluate is left out."""
    code = "\n".join(src.code)
    starts = _offsets(src.code)
    values: dict[str, tuple[int, int]] = {}
    for m in _CONSTEXPR.finditer(code):
        val = _c_eval(m.group(2), {k: v for k, (v, _) in values.items()})
        if val is not None:
            values[m.group(1)] = (val, _where(starts, m.start(1))[0])
    funcs = {m.group(1): (m.group(2), m.group(3))
             for m in _CONSTEXPR_FN.finditer(code)}
    return values, funcs


def _c_eval(expr: str, env: dict[str, int]) -> int | None:
    """Value of a C integer constant expression of literals, names in
    ``env``, ``+ - * / %``, one comparison and ``?:``; None when it is not
    one."""
    text = expr.strip()
    m = re.fullmatch(r"(.+?)\?(.+?):(.+)", text, re.S)
    if m:
        cond = _c_eval(m.group(1), env)
        if cond is None:
            return None
        return _c_eval(m.group(2) if cond else m.group(3), env)
    text = re.sub(r"(\d+)[uUlL]+\b", r"\1", text)
    if not re.fullmatch(r"[\w\s()+\-*/%<>=!]*", text):
        return None
    try:
        tree = ast.parse(text, mode="eval")
    except SyntaxError:
        return None
    return _py_eval(tree.body, env)


def _py_eval(node: ast.expr, env: dict[str, int]) -> int | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = _py_eval(node.operand, env)
        return None if v is None else -v
    if isinstance(node, ast.BinOp):
        a, b = _py_eval(node.left, env), _py_eval(node.right, env)
        if a is None or b is None or (
                isinstance(node.op, (ast.Div, ast.Mod)) and not b):
            return None
        ops = {ast.Add: lambda: a + b, ast.Sub: lambda: a - b,
               ast.Mult: lambda: a * b, ast.Div: lambda: int(a / b),
               ast.Mod: lambda: a % b}
        fn = ops.get(type(node.op))
        return fn() if fn else None
    if isinstance(node, ast.Compare) and len(node.ops) == 1:
        a, b = _py_eval(node.left, env), _py_eval(node.comparators[0], env)
        if a is None or b is None:
            return None
        ops = {ast.Lt: a < b, ast.LtE: a <= b, ast.Gt: a > b, ast.GtE: a >= b,
               ast.Eq: a == b, ast.NotEq: a != b}
        got = ops.get(type(node.ops[0]))
        return None if got is None else int(got)
    return None


def check_cuda(src: CudaSource) -> Iterator[Finding]:
    """RL203 and RL204's own-source half for one ``.cu`` file."""
    if not src.is_kernels:
        return
    yield from _cuda_fp64(src)
    values, _ = _cuda_constants(src)
    for name in _TILE_NAMES:
        if name in values and values[name][0] <= 0:
            yield Finding(
                "blockspec-shape", str(src.path), values[name][1], 0,
                f"tile `{name}` = {values[name][0]} is not positive")


def _check_no_fma(mod: Module) -> Iterator[Finding]:
    flags: dict[str, tuple[ast.AST, object]] = {}
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            try:
                value = ast.literal_eval(node.value)
            except ValueError:
                continue
            flags[node.targets[0].id] = (node, value)
    if "EXTRA_FLAGS" not in flags or not isinstance(
            flags["EXTRA_FLAGS"][1], dict):
        yield Finding(
            "kernel-fp64", str(mod.path), 1, 0,
            "no literal `EXTRA_FLAGS` dict: the assignment kernels need "
            "`-fmad=false` to stay bit-equal to assign_ref")
        return
    node, extra = flags["EXTRA_FLAGS"]
    common = flags.get("NVCC_FLAGS", (None, ()))[1]
    for name in _NO_FMA_KERNELS:
        given = tuple(common) + tuple(extra.get(name, ()))
        on = [f for f in given if f in _FMA_ON]
        if "-fmad=false" not in given or on:
            yield Finding(
                "kernel-fp64", str(mod.path), node.lineno, node.col_offset,
                f"`{name}` must be built with `-fmad=false` (and no "
                f"{' '.join(on) or 'flag turning FMA contraction back on'}): "
                f"a contracted multiply-add breaks its bit-equality with "
                f"assign_ref")


def _py_constants(mod: Module) -> dict[str, tuple[object, int]]:
    """Top-level literal constants, ``name -> (value, line)``, tuple
    targets unpacked."""
    out: dict[str, tuple[object, int]] = {}
    for node in mod.tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target = node.targets[0]
        if isinstance(target, ast.Name):
            names, values = [target], [node.value]
        elif isinstance(target, ast.Tuple) and isinstance(
                node.value, ast.Tuple) and len(target.elts) == len(
                    node.value.elts):
            names, values = target.elts, node.value.elts
        else:
            continue
        for n, v in zip(names, values):
            if not isinstance(n, ast.Name):
                continue
            try:
                out[n.id] = (ast.literal_eval(v), node.lineno)
            except ValueError:
                if isinstance(v, ast.Dict):  # KERNELS: keys -> first item
                    out[n.id] = (_kernel_sources(v), node.lineno)
    return out


def _kernel_sources(node: ast.Dict) -> dict[str, str]:
    """``{"name": ("source", dtype), ...}`` -> ``{"name": "source"}``."""
    out: dict[str, str] = {}
    for k, v in zip(node.keys, node.values):
        if isinstance(k, ast.Constant) and isinstance(v, ast.Tuple) \
                and v.elts and isinstance(v.elts[0], ast.Constant):
            out[str(k.value)] = str(v.elts[0].value)
    return out


def _kernels_dir(logical: str) -> str:
    return logical.rsplit("/kernels/", 1)[0]


def check_kernel_pairs(modules: list[Module],
                       sources: list[CudaSource]) -> Iterator[Finding]:
    """RL204 across the two sides: a kernel module's tile constants
    against the CUDA source it launches, both in the analyzed set (one
    ``kernels/`` directory; the finding is at the Python constant)."""
    by_dir: dict[str, dict[str, CudaSource]] = {}
    for src in sources:
        if src.is_kernels:
            by_dir.setdefault(_kernels_dir(src.logical), {})[
                src.basename] = src
    for mod in modules:
        if not mod.is_kernels:
            continue
        cu = by_dir.get(_kernels_dir(mod.logical), {})
        if not cu:
            continue
        consts = _py_constants(mod)
        for py_file, py_name, cu_file, cu_name in _TILE_PAIRS:
            if mod.basename != py_file or py_name not in consts \
                    or cu_file not in cu:
                continue
            got, line = consts[py_name]
            want = _cuda_constants(cu[cu_file])[0].get(cu_name)
            if not isinstance(got, int) or got <= 0:
                yield Finding("blockspec-shape", str(mod.path), line, 0,
                              f"tile `{py_name}` = {got!r} is not positive")
            elif want is None or want[0] != got:
                yield Finding(
                    "blockspec-shape", str(mod.path), line, 0,
                    f"`{py_name}` = {got} but {cu_file} has `{cu_name}` = "
                    f"{want[0] if want else 'no constant'}")
        if {"TILES", "HEAD_DIMS", "KERNELS"} <= consts.keys():
            yield from _check_flash_tiles(mod, consts, cu)


def _check_flash_tiles(mod: Module, consts: dict[str, tuple[object, int]],
                       cu: dict[str, CudaSource]) -> Iterator[Finding]:
    (tiles, t_line), (dims, d_line) = consts["TILES"], consts["HEAD_DIMS"]
    kernels = consts["KERNELS"][0]
    if not isinstance(tiles, dict) or not isinstance(kernels, dict):
        return
    for kernel, source in sorted(kernels.items()):
        src = cu.get(f"{source}.cu")
        if src is None:
            continue
        built = sorted({int(d) for d in
                        _LAUNCH_DH.findall("\n".join(src.code))})
        if built != sorted(dims):
            yield Finding(
                "blockspec-shape", str(mod.path), d_line, 0,
                f"HEAD_DIMS {tuple(dims)} but {source}.cu instantiates "
                f"launch<Dh> for {tuple(built)}")
        values, funcs = _cuda_constants(src)
        env = {k: v for k, (v, _) in values.items()}

        def tile(fn: str, const: str, dh: int) -> int | None:
            if fn in funcs:
                arg, expr = funcs[fn]
                return _c_eval(expr, {**env, arg: dh})
            return env.get(const)

        for dh in dims:
            got = tiles.get(kernel, {}).get(dh)
            want = (tile("block_q", "kBlockQ", dh),
                    tile("block_k", "kBlockK", dh))
            if got is None or tuple(got) != want or min(tuple(got)) <= 0:
                yield Finding(
                    "blockspec-shape", str(mod.path), t_line, 0,
                    f"TILES[{kernel!r}][{dh}] = {got} but {source}.cu "
                    f"tiles (kBlockQ, kv rows) = {want}")
