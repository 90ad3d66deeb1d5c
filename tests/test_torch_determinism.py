"""The port's determinism lints (``repro_torch.analysis.determinism``)
against the JAX package's, and its PTX lints against their own must-fire
fixtures.

The AST half is held finding-for-finding against ``repro``: every snippet
of ``tests/analysis/test_determinism.py`` and both filter-mask sources give
the same (rule, level, symbol, line) findings, and the port's scan of
``src/repro`` with the reference's globs gives exactly the reference's own.
The PTX half has no reference to compare with (the jaxpr lint enters no
``jit`` body on this JAX: ROADMAP.md Queue 3), so each rule is held to
minimal PTX snippets and to the committed compiler output of the MAP
fixtures.
"""
import re
from pathlib import Path

import pytest

from repro.analysis import determinism as RD
from repro.analysis import fixtures as RF
from repro_torch import native
from repro_torch.analysis import determinism as D
from repro_torch.analysis import fixtures as F
from repro_torch.analysis import gating, load_baseline

REPO = Path(__file__).resolve().parents[1]

# every source snippet of tests/analysis/test_determinism.py
SNIPPETS = {
    "argsort": "import numpy as np\no = np.argsort(k)\n",
    "argsort_stable": 'import numpy as np\no = np.argsort(k, kind="stable")\n',
    "argsort_mergesort": 'import numpy as np\no = np.argsort(k, kind="mergesort")\n',
    "static_P": 'import jax\nf = jax.jit(g, static_argnames="P")\n',
    "static_threshold": 'import jax\nf = jax.jit(g, static_argnames="threshold")\n',
    "static_argnums": (
        "import jax\n"
        "def g(x, threshold):\n"
        "    return x > threshold\n"
        "f = jax.jit(g, static_argnums=(1,))\n"
    ),
    "x64_leak": (
        "import jax\n"
        "def enable():\n"
        '    jax.config.update("jax_enable_x64", True)\n'
        "    do_work()\n"
    ),
    "x64_scoped": (
        "import jax\n"
        "def scoped():\n"
        '    jax.config.update("jax_enable_x64", True)\n'
        "    try:\n"
        "        do_work()\n"
        "    finally:\n"
        '        jax.config.update("jax_enable_x64", False)\n'
    ),
    "legacy_filter_mask": RF.LEGACY_FILTER_MASK_SRC,
    "shipped_filter_mask": RF.SHIPPED_FILTER_MASK_SRC,
}


def keyed(findings):
    return sorted((f.rule, f.level, f.symbol, f.line) for f in findings)


def rules(findings):
    return {f.rule for f in findings}


# ---------------------------------------------------------------------------
# the AST half against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_snippet_findings_match_reference(name):
    src = SNIPPETS[name]
    assert keyed(D.lint_source(src, "snippet")) == keyed(RD.lint_source(src, "snippet"))


def test_filter_mask_sources_are_the_references():
    assert F.LEGACY_FILTER_MASK_SRC == RF.LEGACY_FILTER_MASK_SRC
    assert F.SHIPPED_FILTER_MASK_SRC == RF.SHIPPED_FILTER_MASK_SRC
    assert "static-arg-retrace" in rules(D.lint_source(F.LEGACY_FILTER_MASK_SRC))
    assert not gating(D.lint_source(F.SHIPPED_FILTER_MASK_SRC))


def test_reference_scan_matches_reference_findings():
    want = RD.lint_paths(REPO)
    got = D.lint_paths(REPO, RD.DEFAULT_LINT_GLOBS)
    assert [(f.rule, f.level, f.path, f.symbol, f.line) for f in got] == \
        [(f.rule, f.level, f.path, f.symbol, f.line) for f in want]
    assert "unstable-sort:src/repro/mv/dataplane.py:group_reduce" in \
        {f.fingerprint for f in got}


def test_size_like_static_args_are_the_references():
    assert D.SIZE_LIKE_STATIC_ARGS == RD.SIZE_LIKE_STATIC_ARGS


@pytest.mark.parametrize("src, fires", [
    ("import torch\no = torch.sort(k)\n", True),
    ("import torch\no = torch.sort(k, stable=False)\n", True),
    ("import torch\no = torch.sort(k, stable=True)\n", False),
    ("import torch\no = torch.sort(k, dim=0, stable=True).indices\n", False),
    ("import torch\no = torch.argsort(k)\n", True),
    ("import torch\no = torch.argsort(k, stable=True)\n", False),
    ("o = k.argsort()\n", True),
    ("o = k.argsort(stable=True)\n", False),
    ("o = k.sort()\n", False),  # a list's .sort() is stable; a tensor's is unknowable
    ("import numpy as np\no = np.argsort(k, -1, 'stable')\n", False),
    ("import torch\no = torch.unique(k, sorted=True)\n", False),
])
def test_torch_sort_cases(src, fires):
    got = D.lint_source(src)
    assert rules(got) == ({"unstable-sort"} if fires else set())
    if fires:
        assert got[0].line == src.count("\n") and got[0].symbol == "<module>"


def test_port_source_scan_matches_baseline():
    found = {f.fingerprint for f in gating(D.lint_paths(REPO))}
    assert found == load_baseline(REPO / "tools" / "sc_lint_torch_baseline.json")
    # the scan reads the port's own modules, where every sort is stable
    assert D.DEFAULT_LINT_GLOBS == ("src/repro_torch/mv/*.py",
                                    "src/repro_torch/kernels/*.py")
    assert any(REPO.glob(D.DEFAULT_LINT_GLOBS[0]))


# ---------------------------------------------------------------------------
# the PTX half: rule by rule
# ---------------------------------------------------------------------------

def module(*entries: str, funcs: str = "") -> str:
    return (".version 8.4\n.target sm_90a\n.address_size 64\n\n" + funcs
            + "".join(entries))


def entry(*body: str, name: str = "k") -> str:
    lines = "".join(f"\t{b};\n" for b in body)
    return (f"\t// .globl\t{name}\n.visible .entry {name}(\n\t.param .u64 {name}_param_0\n)\n"
            f"{{\n\t.reg .f32 \t%f<9>;\n{lines}\tret;\n\n}}\n")


@pytest.mark.parametrize("ins, want", [
    ("fma.rn.f32 %f1, %f2, %f3, %f4", {"fma-contraction"}),
    ("fma.rn.f64 %fd1, %fd2, %fd3, %fd4", {"fma-contraction"}),
    ("mad.rn.f32 %f1, %f2, %f3, %f4", {"fma-contraction"}),
    ("mul.f32 %f1, %f2, %f3", {"fma-contraction"}),
    ("add.f64 %fd1, %fd2, %fd3", {"fma-contraction"}),
    ("sub.ftz.f32 %f1, %f2, %f3", {"fma-contraction", "flush-to-zero"}),
    ("add.rn.ftz.f32 %f1, %f2, %f3", {"flush-to-zero"}),
    ("mul.rn.ftz.f32 %f1, %f2, %f3", {"flush-to-zero"}),
    ("div.rn.ftz.f32 %f1, %f2, %f3", {"flush-to-zero"}),
    ("setp.gt.ftz.f32 %p1, %f1, %f2", {"flush-to-zero"}),
    ("cvt.rn.ftz.f32.f64 %f1, %fd1", {"f32-downcast", "flush-to-zero"}),
    ("mul.rn.f32 %f1, %f2, %f3", set()),
    ("add.rn.f32 %f1, %f2, %f3", set()),
    ("sub.rz.f64 %fd1, %fd2, %fd3", set()),
    ("div.rn.f32 %f1, %f2, %f3", set()),
    ("div.rn.f64 %fd1, %fd2, %fd3", set()),
    ("sqrt.rn.f32 %f1, %f2", set()),
    ("rcp.rn.f64 %fd1, %fd2", set()),
    ("ex2.approx.f32 %f1, %f2", {"transcendental-kernel"}),
    ("ex2.approx.ftz.f32 %f1, %f2", {"transcendental-kernel"}),
    ("lg2.approx.f32 %f1, %f2", {"transcendental-kernel"}),
    ("sin.approx.f32 %f1, %f2", {"transcendental-kernel"}),
    ("tanh.approx.f32 %f1, %f2", {"transcendental-kernel"}),
    ("rsqrt.approx.f32 %f1, %f2", {"transcendental-kernel"}),
    ("rcp.approx.ftz.f64 %fd1, %fd2", {"transcendental-kernel"}),
    ("div.approx.f32 %f1, %f2, %f3", {"transcendental-kernel"}),
    ("div.full.f32 %f1, %f2, %f3", {"transcendental-kernel"}),
    ("cvt.rn.f32.f64 %f1, %fd1", {"f32-downcast"}),
    ("cvt.rn.bf16.f32 %rs1, %f1", {"f32-downcast"}),
    ("cvt.rn.f16.f64 %rs1, %fd1", {"f32-downcast"}),
    ("cvt.rn.bf16x2.f32 %r1, %f1, %f2", {"f32-downcast"}),
    ("cvt.rn.f64.s64 %fd1, %rd1", set()),
    ("cvt.f64.f32 %fd1, %f1", set()),
    ("cvt.f32.bf16 %f1, %rs1", set()),
    ("cvt.rni.f64.f64 %fd1, %fd2", set()),
    ("cvt.rzi.s64.f64 %rd1, %fd1", set()),
    ("mad.lo.s64 %rd1, %rd2, %rd3, %rd4", set()),
    ("mad.wide.u32 %rd1, %r2, %r3, %rd4", set()),
    ("mul.wide.s32 %rd1, %r1, 8", set()),
    ("mul.hi.u64 %rd1, %rd2, %rd3", set()),
    ("add.s64 %rd1, %rd2, %rd3", set()),
    ("setp.gt.f32 %p1, %f1, %f2", set()),
    ("abs.f32 %f1, %f2", set()),
    ("neg.f64 %fd1, %fd2", set()),
    ("fma.rn.f16 %rs1, %rs2, %rs3, %rs4", set()),  # float rules cover f32 / f64
])
def test_ptx_rule(ins, want):
    got = D.lint_ptx(module(entry(ins)), "k", "snippet")
    assert rules(got) == want
    for f in got:
        assert (f.level, f.symbol, f.path) == ("warning", "k", "snippet")
        assert f.line == 11  # the instruction's line in the module


def test_ptx_call_into_func_fires():
    funcs = (".func  (.param .b32 func_retval0) helper(\n\t.param .b32 helper_param_0\n)\n"
             "{\n\tfma.rn.f32 \t%f1, %f2, %f3, %f4;\n\tst.param.f32 \t[func_retval0+0], %f1;\n"
             "\tret;\n}\n"
             ".func unused()\n{\n\tex2.approx.f32 \t%f1, %f2;\n\tret;\n}\n")
    body = ("{ // callseq 0, 0\n\t.reg .b32 temp_param_reg;\n\t.param .b32 param0;\n"
            "\tst.param.f32 \t[param0+0], %f1;\n\t.param .b32 retval0;\n"
            "\tcall.uni (retval0), \n\thelper, \n\t(\n\tparam0\n\t)")
    text = module(entry("mul.rn.f32 %f1, %f2, %f3", body,
                        "} // callseq 0\n\tmov.u32 %r1, %r2", name="caller"), funcs=funcs)
    got = D.lint_ptx(text, "caller")
    assert rules(got) == {"fma-contraction"}  # the unreached func's ex2 stays out
    assert "via .func helper" in got[0].message
    parsed = D.parse_ptx(text)
    assert parsed["caller"].calls() == ["helper"]
    assert [f.kind for f in parsed.values()] == ["func", "func", "entry"]


def test_ptx_calls_are_followed_transitively_and_cycles_end():
    funcs = (".func a()\n{\n\tcall.uni b, ();\n\tret;\n}\n"
             ".func b()\n{\n\tcall.uni a, ();\n\tadd.f32 \t%f1, %f2, %f3;\n\tret;\n}\n")
    got = D.lint_ptx(module(entry("call.uni a, ()"), funcs=funcs), "k")
    assert [(f.rule, "via .func b" in f.message) for f in got] == [("fma-contraction", True)]


def test_ptx_statements_guards_labels_and_declarations():
    text = module(
        entry("@%p1 bra $L__BB0_2", "$L__BB0_2:\n\tmul.f32 %f1, %f2, %f3",
              "@!%p2 add.rn.f32 %f1, %f2, %f3", "ld.global.v2.u64 {%rd1, %rd2}, [%rd3]"),
        funcs=(".global .align 1 .b8 $str[3] = {72, 105, 0};\n"
               ".extern .func  (.param .b32 func_retval0) vprintf\n(\n"
               "\t.param .b64 vprintf_param_0\n)\n;\n"),
    )
    fn = D.parse_ptx(text)["k"]
    assert [op for _, op, _ in fn.instructions] == [
        "bra", "mul.f32", "add.rn.f32", "ld.global.v2.u64", "ret"]
    got = D.lint_ptx(text, "k")
    assert [(f.rule, f.line) for f in got] == [("fma-contraction", 19)]
    assert got[0].message.startswith("1 x mul.f32 in k:")


def test_one_finding_per_rule_opcode_and_function():
    got = D.lint_ptx(module(entry(*["fma.rn.f32 %f1, %f2, %f3, %f4"] * 3,
                                  "fma.rn.f64 %fd1, %fd2, %fd3, %fd4")), "k")
    assert sorted(f.message.split(" in ")[0] for f in got) == [
        "1 x fma.rn.f64", "3 x fma.rn.f32"]


@pytest.mark.parametrize("symbol, name", [
    ("_ZN12_GLOBAL__N_114map_two_kernelIfdEEvPKT_PKT0_PDTcvNS_4WideIS0_E4typeE_EcvNS5_IS2_E4typeE_EEEx",
     "map_two_kernel"),
    ("_ZN12_GLOBAL__N_116filter_gt_kernelIffEEvPKT_T0_Phx", "filter_gt_kernel"),
    ("_ZN12_GLOBAL__N_120filter_gt_vec_kernelIffLi2EEEvPKT_T0_Phxi", "filter_gt_vec_kernel"),
    ("_Z13hash64_kernelPKxPyx", "hash64_kernel"),
    ("_Z16legacy_fused_mapPKfS0_Pfx", "legacy_fused_map"),
    ("sc_plain_c_kernel", "sc_plain_c_kernel"),
])
def test_kernel_name(symbol, name):
    assert D.kernel_name(symbol) == name


def test_lint_ptx_selects_entries_by_kernel():
    text = module(entry("mul.f32 %f1, %f2, %f3", name="_Z1aPf"),
                  entry("ex2.approx.f32 %f1, %f2", name="_Z1bPf"))
    assert rules(D.lint_ptx(text, "s", kernel="a")) == {"fma-contraction"}
    assert rules(D.lint_ptx(text, "s", kernel="b")) == {"transcendental-kernel"}
    assert rules(D.lint_ptx(text, "s")) == {"fma-contraction", "transcendental-kernel"}


# ---------------------------------------------------------------------------
# the committed compiler output of the MAP fixtures
# ---------------------------------------------------------------------------

def test_committed_legacy_map_ptx_fires_both_rules():
    got = D.lint_ptx(F.LEGACY_FUSED_MAP_PTX, "legacy_fused_map")
    assert {"transcendental-kernel", "fma-contraction"} <= rules(got)
    entries = [n for n, f in D.parse_ptx(F.LEGACY_FUSED_MAP_PTX).items() if f.kind == "entry"]
    assert [D.kernel_name(n) for n in entries] == ["legacy_fused_map"]


def test_committed_shipped_map_ptx_is_quiet():
    parsed = D.parse_ptx(F.SHIPPED_MAP_PTX)
    entries = [n for n, f in parsed.items() if f.kind == "entry"]
    assert [D.kernel_name(n) for n in entries] == ["shipped_map"]
    assert D.lint_ptx(F.SHIPPED_MAP_PTX, "shipped_map") == []
    ops = {op for f in parsed.values() for _, op, _ in f.instructions}
    assert {"mul.rn.f32", "add.rn.f32", "div.rn.f32"} <= ops


def test_committed_ptx_names_its_compiler():
    assert re.search(r"release \d+\.\d+", F.PTX_NVCC)
    for text in (F.LEGACY_FUSED_MAP_PTX, F.SHIPPED_MAP_PTX):
        assert F.PTX_NVCC.split(", ")[-1] in text  # the V<version> of the header
        assert ".target sm_90a" in text


# ---------------------------------------------------------------------------
# the data-plane pass
# ---------------------------------------------------------------------------

def test_dataplane_kernels_list_every_kernel_of_the_source():
    src = (native.CSRC / "dataplane.cu").read_text()
    found = re.findall(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s*)?"
                       r"(?:void\s+)?(\w+)\s*\(", src)
    assert sorted(found) == sorted(D.DATAPLANE_KERNELS)


def test_dataplane_lint_without_nvcc_is_one_skip(monkeypatch):
    monkeypatch.setattr(native, "nvcc_path", lambda: None)
    got, counts = D.lint_dataplane_kernels()
    assert [(f.rule, f.level) for f in got] == [("lint-skipped", "info")]
    assert not gating(got) and counts == {}


def test_dataplane_lint_per_kernel(monkeypatch):
    """The pass over a stand-in module: every entry linted under its
    kernel's name, a listed kernel with no entry skipped, and the counts of
    instantiations and instructions read."""
    names = {k: f"_ZN12_GLOBAL__N_1{len(k)}{k}IfEEvPKT_x" for k in D.DATAPLANE_KERNELS}
    entries = [entry("mul.rn.f32 %f1, %f2, %f3", name=names[k])
               for k in D.DATAPLANE_KERNELS if k != "hash64_kernel"]
    entries.append(entry("fma.rn.f32 %f1, %f2, %f3, %f4",
                         name=names["map_two_kernel"].replace("IfE", "IdE")))
    monkeypatch.setattr(native, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(native, "build_ptx", lambda name: module(*entries))
    findings, counts = D.lint_dataplane_kernels()
    assert [(f.rule, f.level, f.symbol, f.path) for f in findings] == [
        ("lint-skipped", "info", "hash64_kernel", D.DATAPLANE_SOURCE),
        ("fma-contraction", "warning", "map_two_kernel", D.DATAPLANE_SOURCE),
    ]
    assert "hash64_kernel" not in counts
    assert counts["map_two_kernel"] == (2, 4)
    assert counts["filter_gt_kernel"] == (1, 2)


def test_ptx_build_paths_are_content_keyed_and_need_nvcc(monkeypatch):
    assert native.ptx_path("dataplane").suffix == ".ptx"
    assert native.ptx_path("dataplane").stem != native.library_path("dataplane").stem
    assert native.ptx_path("dataplane").parent == native.BUILD_DIR
    assert native.PTX_FLAGS == ("-arch=compute_90a", "-ptx", "-std=c++17", "-O3")
    # a device flag added to the library's build reaches the linted PTX too
    extra = ("--fmad=false", "-ftz=true", "--use_fast_math", "-DX=1")
    assert native.ptx_flags((*native.NVCC_FLAGS, *extra)) == (*native.PTX_FLAGS, *extra)
    monkeypatch.setattr(native, "nvcc_path", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        native.build_ptx("dataplane")


# ---------------------------------------------------------------------------
# on the machine with the card: dataplane.cu compiled now, and copies of it
# with one hazard each in map_two_kernel, compiled the same way
# ---------------------------------------------------------------------------

MAP_SUM = "out[i] = add_rn(static_cast<TO>(p), static_cast<TO>(s));"
MUTANTS = {
    # the sum as plain C++: an unrounded add that ptxas may contract
    "plain_add": ("add_rn(static_cast<TO>(p), static_cast<TO>(s))",
                  "static_cast<TO>(p) + static_cast<TO>(s)", {"fma-contraction"}),
    # the product and sum as one expression: NVVM contracts it into fma.rn
    "fused": (MAP_SUM, "out[i] = static_cast<TO>(widen(a[i])) * static_cast<TO>(c) + "
              "static_cast<TO>(s);", {"fma-contraction"}),
    # tanh in place of the softsign: an approximate exp2 / reciprocal
    "tanh": ("const TS s = softsign(b[i]);", "const TS s = tanhf(softsign(b[i]));",
             {"transcendental-kernel"}),
    # the sum taken in f32 for every width
    "downcast": (MAP_SUM, "out[i] = static_cast<TO>(add_rn(static_cast<float>(p), "
                 "static_cast<float>(s)));", {"f32-downcast"}),
}


@pytest.fixture
def nvcc():
    if native.nvcc_path() is None:
        pytest.skip("needs nvcc (the machine with the card)")


@pytest.mark.cuda
def test_shipped_dataplane_ptx_is_clean(nvcc):
    findings, counts = D.lint_dataplane_kernels()
    assert findings == []
    assert sorted(counts) == sorted(D.DATAPLANE_KERNELS)
    assert all(entries >= 1 and instructions > 0 for entries, instructions in counts.values())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MUTANTS))
def test_dataplane_mutant_fires(nvcc, name):
    old, new, want = MUTANTS[name]
    src = (native.CSRC / "dataplane.cu").read_text()
    assert src.count(old) == 1
    ptx = native.compile_ptx(src.replace(old, new), f"mutant_{name}")
    assert want <= rules(D.lint_ptx(ptx, "map_two_kernel", kernel="map_two_kernel"))
    # the other kernels of the copy stay as clean as the shipped source
    assert not D.lint_ptx(ptx, "map_one_kernel", kernel="map_one_kernel")


@pytest.mark.cuda
def test_fresh_map_fixtures_fire_as_committed(nvcc):
    for src, committed, name in (
            (F.LEGACY_FUSED_MAP_CU, F.LEGACY_FUSED_MAP_PTX, "legacy_fused_map"),
            (F.SHIPPED_MAP_CU, F.SHIPPED_MAP_PTX, "shipped_map")):
        fresh = native.compile_ptx(src, f"fixture_{name}")
        assert rules(D.lint_ptx(fresh, name)) == rules(D.lint_ptx(committed, name))
