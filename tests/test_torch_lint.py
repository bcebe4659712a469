"""The port's linter (``repro_torch.analysis.lint``) against the reference's
(``repro.analysis.lint``), and its torch and CUDA checks, on the CPU.

- Corpus parity: every file of ``tests/lint_corpus/`` is read (never
  written), its path directive retargeted from ``src/repro/`` to
  ``src/repro_torch/`` into ``tmp_path``, and the port's findings (rule,
  line, column) must be the reference's on the original. The port keeps
  ``ComponentIndex`` in ``core/fabric.py``, so a file that poses as the
  reference's ``core/engine.py`` to own it poses as the port's
  ``core/fabric.py``.
- One offender per torch or CUDA check, written from strings into
  ``tmp_path`` under ``src/repro_torch/``, with one clean counterpart
  each: the offender gives exactly its expected (line, rule) pairs, the
  counterpart none.
- A mutation control: the port's ``FabricManager`` without its cache purge
  on a fault trips RL301.
- The effect vocabularies of the port, its linter and the reference agree;
  the port's tree lints clean with all 15 declarations and the four CUDA
  sources; the CLI's exit codes.

Directive literals in this file are assembled from pieces, because both
linters read every line of it for them.
"""
from __future__ import annotations

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis.lint import lint_paths as ref_lint_paths
from repro_torch.analysis.lint import DEFAULT_EXCLUDES, RULES, lint_paths

REPO = Path(__file__).resolve().parent.parent
CORPUS = REPO / "tests" / "lint_corpus"
DIRECTIVE = "# reprolint" + ": "
PRETEND = DIRECTIVE + "pretend-path="
CPP_DISABLE = "// reprolint" + ": disable="
#: the port's home of the classes the reference keeps in core/engine.py
PORT_LAYOUT = {"src/repro_torch/core/engine.py":
               "src/repro_torch/core/fabric.py"}


def triples(report) -> list[tuple[str, int, int]]:
    return sorted((f.rule, f.line, f.col) for f in report.findings)


def pairs(report) -> list[tuple[int, str]]:
    return sorted((f.line, f.rule) for f in report.findings)


def retarget(text: str) -> str:
    text = text.replace(PRETEND + "src/repro/", PRETEND + "src/repro_torch/")
    for ref_path, port_path in PORT_LAYOUT.items():
        text = text.replace(PRETEND + ref_path, PRETEND + port_path)
    return text


# ------------------------------------------------------------ corpus parity

@pytest.mark.parametrize("name", sorted(p.name for p in CORPUS.glob("*.py")))
def test_corpus_findings_equal_the_references(name, tmp_path):
    original = CORPUS / name
    want = ref_lint_paths([original], root=REPO)
    copy = tmp_path / name
    copy.write_text(retarget(original.read_text(encoding="utf-8")),
                    encoding="utf-8")
    got = lint_paths([copy], root=tmp_path)
    assert triples(got) == triples(want)
    assert len(got.suppressed) == len(want.suppressed)


def test_component_index_owner_moved_to_fabric(tmp_path):
    # the same mutations are the owner's own in core/fabric.py (above) and
    # a finding in core/engine.py, which does not own the index here
    src = (CORPUS / "clean_component_index.py").read_text(encoding="utf-8")
    copy = tmp_path / "engine_copy.py"
    copy.write_text(src.replace(PRETEND + "src/repro/",
                                PRETEND + "src/repro_torch/"),
                    encoding="utf-8")
    assert pairs(lint_paths([copy], root=tmp_path)) == [
        (9, "commit-mutation"), (10, "commit-mutation"),
        (11, "commit-mutation")]


# ------------------------------------------- torch and CUDA checks, one each

def lint_tree(tmp_path: Path, files: dict[str, str]):
    for rel, text in files.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(text).lstrip("\n"), encoding="utf-8")
    return lint_paths([tmp_path], root=tmp_path)


CORE = "src/repro_torch/core/"
KERNELS = "src/repro_torch/kernels/"
CU_GOOD = """
    // a double is named here, and 1.0 too, in a comment
    constexpr int kChunk = 512;
    constexpr int kStages = 4;
    double host_side(double x) { return x * 0.5; }
    __device__ __forceinline__ float half(float x) { return x * 0.5f; }
    __global__ void k(float* p) {
      const char* s = "1.0 double";
      p[0] = half(1.0f) + 2e3f + __fadd_rn(1.0f, 2.0f);
    }
"""
BUILD_GOOD = """
    NVCC_FLAGS = ("-O3",)
    EXTRA_FLAGS = {"coflow_assign_sm90": ("-fmad=false",),
                   "coflow_assign_lanes_sm90": ("-fmad=false",)}
"""
LANES_PY = """
    LANES_CHUNK, LANES_STAGES = 512, 4
    LANES_PER_LANE = {per_lane}
"""
LANES_CU = """
    constexpr int kChunk = 512;
    constexpr int kStages = 4;
    constexpr int kMaxPerLane = 8;
    __global__ void k(float* p, unsigned* w) {{
      p[0] = fmaxf(p[1], {zero});
      w[0] = __reduce_min_sync(0xffffffffu, w[1]);
    }}
"""
FLASH_PY = """
    import torch
    HEAD_DIMS = (64, 128, 256)
    TILES = {{"sm90_bf16": {{64: (128, 128), 128: (128, 128), 256: {t256}}}}}
    KERNELS = {{"sm90_bf16": ("flash_attention_sm90", torch.bfloat16)}}
"""
FLASH_CU = """
    constexpr int kBlockQ = 128;
    constexpr int kBlockK = 128;
    __host__ __device__ constexpr int block_k(int dh) {{ return dh > 128 ? 64 : kBlockK; }}
    template <int kDh> int launch() {{ return kDh; }}
    int go(int dh) {{
      if (dh == 64) return launch<64>();
      if (dh == 128) return launch<128>();
      return launch<{last}>();
    }}
"""

# The fp32 kernel's q rows depend on the head dim: a block_q(Dh) function.
FLASH32_PY = """
    import torch
    HEAD_DIMS = (64, 128, 256)
    TILES = {{"sm90_fp32": {{64: (128, 64), 128: (128, 64), 256: {t256}}}}}
    KERNELS = {{"sm90_fp32": ("flash_attention_fp32_sm90", torch.float32)}}
"""
FLASH32_CU = """
    constexpr int kBlockK = 64;
    __host__ __device__ constexpr int block_q(int dh) { return dh > 128 ? 64 : 128; }
    template <int kDh> int launch() { return kDh; }
    int go(int dh) {
      if (dh == 64) return launch<64>();
      if (dh == 128) return launch<128>();
      return launch<256>();
    }
"""

# name -> (offending files, expected (line, rule) pairs, clean files)
CASES = {
    "torch-sampler": (
        {CORE + "a.py": """
            import torch
            x = torch.randn(3)
            y = torch.randint(0, 5, (3,))
            z = torch.rand_like(x)
        """},
        [(2, "global-rng"), (3, "global-rng"), (4, "global-rng")],
        {CORE + "a.py": """
            import torch
            g = torch.Generator().manual_seed(0)
            x = torch.randn(3, generator=g)
            y = torch.randint(0, 5, (3,), generator=g)
        """}),
    "torch-random-fill": (
        {CORE + "a.py": """
            import torch
            w = torch.empty(3).uniform_(0.0, 1.0)
            torch.nn.init.normal_(w)
        """},
        [(2, "global-rng"), (3, "global-rng")],
        {CORE + "a.py": """
            import torch
            g = torch.Generator().manual_seed(0)
            w = torch.empty(3).uniform_(0.0, 1.0, generator=g)
            torch.nn.init.normal_(w, generator=g)
        """}),
    "torch-global-seed": (
        {"tests/t.py": """
            import torch
            torch.manual_seed(0)
            torch.cuda.manual_seed_all(0)
        """},
        [(2, "global-rng"), (3, "global-rng")],
        {"tests/t.py": """
            import torch
            g = torch.Generator(device="cpu").manual_seed(0)
        """}),
    "torch-unseeded": (
        {CORE + "a.py": """
            import torch
            torch.seed()
            g = torch.Generator()
            g.seed()
            torch.Generator().seed()
        """},
        [(2, "unseeded-rng"), (4, "unseeded-rng"), (5, "unseeded-rng")],
        {CORE + "a.py": """
            import torch
            g = torch.Generator()
            g.manual_seed(7)
            s = g.initial_seed()
        """}),
    "torch-float-eq": (
        {CORE + "a.py": """
            import torch


            def f(x: torch.Tensor, n: torch.Tensor) -> bool:
                a = torch.zeros(3)
                b = n.double()
                c = torch.as_tensor(n, dtype=torch.float64)
                d = n.to(torch.float32)
                return bool((a == n).all()) and bool((b != n).all()) \\
                    and bool(torch.eq(c, n).all()) and bool(d.ne(n).all())
        """},
        [(9, "float-eq"), (9, "float-eq"), (10, "float-eq"),
         (10, "float-eq")],
        {CORE + "a.py": """
            import torch


            def f(x: torch.Tensor, n: torch.Tensor) -> bool:
                a = torch.zeros(3, dtype=torch.int64)
                b = n.long()
                c = torch.arange(3)
                return bool((a == n).all()) and bool((b != n).all()) \\
                    and bool(torch.eq(c, n).all()) \\
                    and bool(torch.isclose(n.double(), n.double()).all())
        """}),
    "torch-commit-mutation": (
        {"src/repro_torch/service/a.py": """
            import torch
            from repro_torch.core.engine import FlowTable


            def tamper(table: FlowTable, x: torch.Tensor) -> None:
                table.size.copy_(x)
                table.core[0].zero_()
                torch.index_put_(table.t, (x,), x)
                table.fi.masked_fill_(x > 0, 0)
        """},
        [(5, "commit-finality"), (6, "commit-mutation"),
         (7, "commit-mutation"), (8, "commit-mutation"),
         (9, "commit-mutation")],
        {CORE + "engine.py": """
            import torch
            from repro_torch.core.engine import FlowTable


            def tamper(table: FlowTable, x: torch.Tensor) -> None:
                table.size.copy_(x)
                table.core[0].zero_()
                y = table.fi.clone().masked_fill_(x > 0, 0)
        """}),
    "cuda-fp64": (
        {KERNELS + "csrc/k.cu": """
            __device__ float g(float x) { return x * 0.5; }
            __global__ void k(double* p) {
              p[0] = 1.0f + 2e3 + __dadd_rn(1.0, 2.0f);
            }
        """},
        [(1, "kernel-fp64"), (2, "kernel-fp64"), (3, "kernel-fp64"),
         (3, "kernel-fp64"), (3, "kernel-fp64")],
        {KERNELS + "csrc/k.cu": CU_GOOD}),
    "cuda-suppression": (
        {KERNELS + "csrc/k.cu": f"""
            __global__ void k(float* p) {{
              p[0] = 0.5;  {CPP_DISABLE}kernel-fp64
              p[1] = 0.5;  {CPP_DISABLE}no-such-rule -- why
            }}
        """},
        [(2, "bad-suppression"), (2, "kernel-fp64"), (3, "bad-suppression"),
         (3, "kernel-fp64")],
        {KERNELS + "csrc/k.cu": f"""
            __global__ void k(float* p) {{
              p[0] = 0.5;  {CPP_DISABLE}kernel-fp64 -- a test of the syntax
            }}
        """}),
    "build-fmad": (
        {KERNELS + "_build.py": """
            NVCC_FLAGS = ("-O3", "--use_fast_math")
            EXTRA_FLAGS = {"coflow_assign_sm90": ("-fmad=false",)}
        """},
        [(2, "kernel-fp64"), (2, "kernel-fp64")],
        {KERNELS + "_build.py": BUILD_GOOD}),
    "lanes-kernel": (
        {KERNELS + "_build.py": """
            EXTRA_FLAGS = {"coflow_assign_sm90": ("-fmad=false",)}
         """,
         KERNELS + "coflow_assign.py": LANES_PY.format(per_lane=4),
         KERNELS + "csrc/coflow_assign_lanes_sm90.cu": LANES_CU.format(
             zero="0.0")},
        [(1, "kernel-fp64"), (2, "blockspec-shape"), (5, "kernel-fp64")],
        {KERNELS + "_build.py": BUILD_GOOD,
         KERNELS + "coflow_assign.py": LANES_PY.format(per_lane=8),
         KERNELS + "csrc/coflow_assign_lanes_sm90.cu": LANES_CU.format(
             zero="0.0f")}),
    "chain-tiles": (
        {KERNELS + "coflow_assign.py": "CHAIN_CHUNK, CHAIN_STAGES = 256, 4\n",
         KERNELS + "csrc/coflow_assign_sm90.cu": CU_GOOD.replace(
             "kStages = 4", "kStages = 0")},
        [(1, "blockspec-shape"), (1, "blockspec-shape"),
         (3, "blockspec-shape")],
        {KERNELS + "coflow_assign.py": "CHAIN_CHUNK, CHAIN_STAGES = 512, 4\n",
         KERNELS + "csrc/coflow_assign_sm90.cu": CU_GOOD}),
    "flash-tiles-block-q": (
        {KERNELS + "flash_attention.py": FLASH32_PY.format(t256="(128, 64)"),
         KERNELS + "csrc/flash_attention_fp32_sm90.cu": FLASH32_CU},
        [(3, "blockspec-shape")],
        {KERNELS + "flash_attention.py": FLASH32_PY.format(t256="(64, 64)"),
         KERNELS + "csrc/flash_attention_fp32_sm90.cu": FLASH32_CU}),
    "cuda-header": (
        {KERNELS + "csrc/common.cuh": """
            #pragma once
            __device__ float g(float x) { return x * 0.5; }
        """},
        [(2, "kernel-fp64")],
        {KERNELS + "csrc/common.cuh": """
            #pragma once
            __device__ float g(float x) { return x * 0.5f; }
        """}),
    "flash-tiles": (
        {KERNELS + "flash_attention.py": FLASH_PY.format(t256="(128, 128)"),
         KERNELS + "csrc/flash_attention_sm90.cu": FLASH_CU.format(last=512)},
        [(2, "blockspec-shape"), (3, "blockspec-shape")],
        {KERNELS + "flash_attention.py": FLASH_PY.format(t256="(128, 64)"),
         KERNELS + "csrc/flash_attention_sm90.cu": FLASH_CU.format(last=256)}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_and_cuda_checks_fire_on_offender_only(case, tmp_path):
    bad, expect, good = CASES[case]
    report = lint_tree(tmp_path / "bad", bad)
    assert pairs(report) == sorted(expect), "\n".join(
        f.render() for f in report.findings)
    clean = lint_tree(tmp_path / "good", good)
    assert clean.ok, "\n".join(f.render() for f in clean.findings)


def test_cuda_sources_are_walked_only_under_kernels_csrc(tmp_path):
    report = lint_tree(tmp_path, {
        KERNELS + "csrc/k.cu": CU_GOOD,
        "src/repro_torch/other/csrc/x.cu": "double d = 1.0;\n",
        KERNELS + "csrc/build/y.cu": "double d = 1.0;\n",
    })
    assert report.cuda_files == [KERNELS + "csrc/k.cu"]
    assert report.ok


def test_justified_cuda_suppression_is_counted(tmp_path):
    _, _, good = CASES["cuda-suppression"]
    report = lint_tree(tmp_path, good)
    assert report.ok and [f.rule for f in report.suppressed] == [
        "kernel-fp64"]


# ------------------------------------------- mutation negative control (RL301)

_PURGE_CALL = (
    "            purged = self.cache.invalidate(\n"
    "                lambda prog: bool((prog.core == k).any()))")


def _lint_manager_trio(manager_source: str, tmp_path: Path):
    """Lint a (possibly mutated) copy of the port's service/manager.py with
    the real core/fabric.py and service/cache.py, so cross-module effect
    propagation resolves. The directive goes at the end so line numbers
    match the original."""
    mutant = tmp_path / "manager_copy.py"
    mutant.write_text(manager_source + "\n" + PRETEND
                      + "src/repro_torch/service/manager.py\n",
                      encoding="utf-8")
    port = REPO / "src" / "repro_torch"
    report = lint_paths([mutant, port / "core" / "fabric.py",
                         port / "service" / "cache.py"], root=REPO)
    return mutant, report


def test_unmutated_manager_trio_is_clean(tmp_path):
    src = (REPO / "src/repro_torch/service/manager.py").read_text(
        encoding="utf-8")
    assert _PURGE_CALL in src, "purge call text drifted; update _PURGE_CALL"
    _, report = _lint_manager_trio(src, tmp_path)
    assert report.ok, "\n".join(f.render() for f in report.findings)


def test_deleting_report_fault_purge_trips_rl301(tmp_path):
    src = (REPO / "src/repro_torch/service/manager.py").read_text(
        encoding="utf-8")
    mutated = src.replace(_PURGE_CALL, "            purged = 0")
    assert mutated != src
    mutant, report = _lint_manager_trio(mutated, tmp_path)
    def_line = next(
        i for i, text in enumerate(mutated.splitlines(), start=1)
        if text.lstrip().startswith("def report_fault("))
    got = {(f.line, f.rule) for f in report.findings
           if f.path == str(mutant)}
    assert (def_line, "cache-coherence") in got
    assert {rule for _, rule in got} == {"cache-coherence"}


# ---------------------------------------------------------- vocabularies

def test_effect_vocabularies_match():
    from repro.core.effects import EFFECTS as ref_effects
    from repro_torch.analysis.lint.effects import EFFECTS as lint_effects
    from repro_torch.core.effects import EFFECTS as port_effects
    assert port_effects == lint_effects == ref_effects


def test_rule_table_is_the_references():
    from repro.analysis.lint.common import RULES as ref_rules
    assert RULES == ref_rules
    assert DEFAULT_EXCLUDES == {"lint_corpus", "__pycache__", ".git", "out",
                                ".pytest_cache", ".mypy_cache"}


def test_port_effects_decorator_attaches_and_validates():
    from repro_torch.core.effects import effects

    @effects("cache-read", "rng-consume")
    def f() -> None:
        return None

    assert f.__effects__ == frozenset({"cache-read", "rng-consume"})
    with pytest.raises(ValueError, match="unknown effect"):
        effects("not-an-effect")


# ------------------------------------------------------------ the port tree

PORT_TREE = (["src/repro_torch", "chip_smoke.py", "scripts/chain_ladder.py",
              "scripts/lanes_ladder.py"]
             + sorted(str(p.relative_to(REPO)) for pattern in (
                 "tests/test_torch_*.py", "scripts/chip_*.py",
                 "examples/torch_*.py") for p in REPO.glob(pattern)))


#: The port's CUDA sources and the header two of them share, in the order
#: the linter reads them.
CUDA_FILES = [f"src/repro_torch/kernels/csrc/{name}" for name in (
    "coflow_assign_lanes_sm90.cu", "coflow_assign_sm90.cu",
    "flash_attention_fp32_sm90.cu", "flash_attention_sm90.cu",
    "sm90_common.cuh")]


def test_port_tree_lints_clean():
    report = lint_paths([REPO / p for p in PORT_TREE], root=REPO)
    assert report.ok, "\n".join(f.render() for f in report.findings)
    assert report.protocol["declared"] == 15
    assert report.cuda_files == CUDA_FILES
    assert {f.rule for f in report.suppressed} == {"float-eq"}
    assert len(report.suppressed) == 8


# -------------------------------------------------------------- CLI contract

def _run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", *args],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})


def test_cli_exit_codes_and_json(tmp_path):
    out = tmp_path / "report.json"
    ok = _run_cli("--json", str(out), *PORT_TREE)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    payload = json.loads(out.read_text())
    assert payload["ok"] is True and payload["finding_count"] == 0
    assert payload["protocol"]["declared"] == 15
    assert len(payload["cuda_files"]) == len(CUDA_FILES)
    assert f"{len(CUDA_FILES)} CUDA sources" in ok.stdout \
        and "-> clean" in ok.stdout

    bad_file = tmp_path / "src" / "repro_torch" / "core" / "a.py"
    bad_file.parent.mkdir(parents=True)
    bad_file.write_text("import torch\nx = torch.randn(3)\n")
    bad = _run_cli("--json", "-", "--quiet", str(bad_file))
    assert bad.returncode == 1
    payload = json.loads(bad.stdout)
    assert payload["ok"] is False
    assert payload["by_rule"] == {"global-rng": 1}
