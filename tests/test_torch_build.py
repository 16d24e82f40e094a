"""The port's kernel build helpers (distkeras_tpu_torch/ops/_build.py) on
the CPU: no nvcc is needed to check how a library is named and how the
compiler's and the disassembler's reports are read.

- A library's name hashes its source, every shared header under
  ``csrc/`` and the flags, so editing a header (the wgmma, TMA and
  mbarrier helpers in ``hopper.cuh``) never loads a stale build.
- ``ptxas_report`` reads registers, stack and spills per kernel from
  ``ptxas -v``; ``count_sass`` counts instructions by opcode per function
  of a ``cuobjdump -sass`` listing, predicated ones included (the check
  that a kernel issues ``HGMMA`` and ``UTMALDG``).
- ``chip_smoke.check_sass`` holds every kernel redesigned on wgmma (K3's
  dq kernel, the small-D flash kernels at D = 16 and 32 and every
  instantiation of K1's prefill among them) and the scans to those
  reports; it is imported here without a card and fed
  made-up reports.
"""

import importlib.util
import os
import types

import pytest

from distkeras_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119fa_fwd_wgmma_kernelILi128EEvv' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119fa_fwd_wgmma_kernelILi128EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 480 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113fa_fwd_kernelIfEEvv' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113fa_fwd_kernelIfEEvv
    40 bytes stack frame, 68 bytes spill stores, 56 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 440 bytes cmem[0]
"""

SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_119fa_fwd_wgmma_kernelILi128EEvv
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/              @!P0 UTMALDG.4D [UR8], [UR4] ;
        /*0020*/                   UTMALDG.4D [UR16], [UR4] ;
        /*0030*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT ;
        /*0040*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR12], R24, gsb0 ;
        /*0050*/              @UP0 HGMMA.64x64x16.F32.BF16 R88, R152, gdesc[UR20], R88 ;
\t\t..........
\t\tFunction : _ZN12_GLOBAL__N_113fa_fwd_kernelIfEEvv
        /*0000*/                   FFMA R0, R1, R2, R0 ;
        /*0010*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
"""


def _tree(tmp_path, header="// v1\n"):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text(header)


def test_library_name_hashes_source_headers_and_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    _tree(tmp_path)
    first = _build._library_path("k")
    assert first == _build._library_path("k")           # stable
    (tmp_path / "h.cuh").write_text("// v2\n")          # a header edit
    second = _build._library_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edit\n')
    assert _build._library_path("k") not in (first, second)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build._library_path("k") != second
    assert _build._log_path("k").endswith(".ptxas.txt")


def test_ptxas_report_reads_registers_and_spills():
    rep = _build.ptxas_report(PTXAS)
    wgmma = rep["_ZN12_GLOBAL__N_119fa_fwd_wgmma_kernelILi128EEvv"]
    fma = rep["_ZN12_GLOBAL__N_113fa_fwd_kernelIfEEvv"]
    assert wgmma == dict(stack=0, spill_stores=0, spill_loads=0,
                         registers=168)
    assert fma == dict(stack=40, spill_stores=68, spill_loads=56,
                       registers=32)


@pytest.mark.parametrize("opcodes", [("HGMMA", "UTMALDG"),
                                     ("HGMMA", "UTMALDG", "HMMA")])
def test_count_sass_counts_opcodes_per_function(opcodes):
    counts = _build.count_sass(SASS, opcodes)
    wgmma = counts["_ZN12_GLOBAL__N_119fa_fwd_wgmma_kernelILi128EEvv"]
    fma = counts["_ZN12_GLOBAL__N_113fa_fwd_kernelIfEEvv"]
    assert (wgmma["HGMMA"], wgmma["UTMALDG"]) == (3, 2)
    assert (fma["HGMMA"], fma["UTMALDG"]) == (0, 0)
    if "HMMA" in opcodes:          # mma.sync, not counted as HGMMA
        assert (wgmma["HMMA"], fma["HMMA"]) == (0, 1)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_wgmma_kernels_name_the_dq_kernel():
    cs = _chip_smoke()
    assert cs.WGMMA_KERNELS["flash_attention_bwd_dq"] == (
        "flash_attention_bwd", "fa_bwd_dq_wgmma_kernel")
    assert cs.WGMMA_KERNELS_ONE["lstm_backward"] == (
        "lstm", "lstm_dwh_wgmma_kernel")
    assert cs.WGMMA_KERNELS_ONE["q_matmul_prefill"] == (
        "quant", "qmm_prefill_wgmma_kernel")
    assert cs.NO_SPILL_KERNELS["lstm_forward"] == (
        "lstm", "lstm_fwd_cluster_kernel")
    assert cs.SMALL_KERNELS == {
        "flash_attention_small": ("flash_attention", "fa_fwd_small_kernel"),
        "flash_attention_bwd_small": ("flash_attention_bwd",
                                      "fa_bwd_small_kernel")}


# template arguments of the made-up instantiations of each templated kernel
_INSTANCES = {"qmm_prefill_wgmma_kernel": ("ILi256ELi2E", "ILi64ELi1E"),
              "lstm_fwd_cluster_kernel": ("ILi128ELi4E", "ILi32ELi2E"),
              "lstm_bwd_kernel": ("I13__nv_bfloat16Lb1E", "IfLb0E"),
              "lstm_bwd_direct_kernel": ("I13__nv_bfloat16Lb1E", "IfLb0E"),
              "qmm_decode_split_kernel": ("ILb0E", "ILb1E")}


def _fake_build(cs, spilled=None, hgmma=4, no_hgmma_in=None):
    """A stand-in for ``_build`` whose libraries hold every kernel that
    ``check_sass`` looks for, the templated ones in two instantiations;
    ``spilled`` names one that spills, ``no_hgmma_in`` one whose SASS has
    no HGMMA."""
    funcs = {}
    for table, dims in ((cs.WGMMA_KERNELS, (64, 128)),
                        (cs.SMALL_KERNELS, (16, 32))):
        for lib, fn in table.values():
            for d in dims:
                funcs.setdefault(lib, []).append(
                    f"_ZN12_GLOBAL__N_1{len(fn) + 7}{fn}ILi{d}EEEvv")
    for lib, fn in [*cs.WGMMA_KERNELS_ONE.values(),
                    *cs.NO_SPILL_KERNELS.values()]:
        for args in _INSTANCES.get(fn, ("",)):
            funcs.setdefault(lib, []).append(
                f"_ZN12_GLOBAL__N_1{len(fn)}{fn}{args}Evv")

    def build_log(lib):
        text = ""
        for f in funcs[lib]:
            spill = 16 if spilled and spilled in f else 0
            text += (f"ptxas info    : Compiling entry function '{f}' for "
                     f"'sm_90a'\nptxas info    : Function properties for "
                     f"{f}\n    {spill} bytes stack frame, {spill} bytes "
                     f"spill stores, {spill} bytes spill loads\nptxas info"
                     f"    : Used 168 registers, used 1 barriers\n")
        return text

    def sass_counts(lib):
        return {f: {"HGMMA": 0 if no_hgmma_in and no_hgmma_in in f
                    else hgmma, "UTMALDG": 2} for f in funcs[lib]}

    return types.SimpleNamespace(
        build_log=build_log, ptxas_report=_build.ptxas_report,
        sass_counts=sass_counts)


@pytest.mark.parametrize("fault", [None, "fa_bwd_dq_wgmma_kernelILi128E",
                                   "lstm_dwh_wgmma_kernel", "no_hgmma",
                                   "qmm_prefill_wgmma_kernelILi256E",
                                   "no_hgmma_qmm", "lstm_fwd_cluster_kernel",
                                   "lstm_bwd_kernel",
                                   "fa_fwd_small_kernelILi32E",
                                   "fa_bwd_small_kernelILi16E",
                                   "no_hgmma_small"])
def test_check_sass_holds_each_wgmma_kernel(fault):
    """``check_sass`` passes clean reports and fails on a spill in any
    checked kernel (K3 at D=128, the dwh product, one instantiation of
    K1's wgmma prefill, K6's cluster scan, K7's staged scan, the small-D
    forward at D=32 and the fused small-D backward at D=16) and on a
    wgmma kernel with no HGMMA (all of them, K1's prefill alone, or the
    small-D forward alone)."""
    cs = _chip_smoke()
    cs.log = lambda msg: None
    if fault is None:
        out = cs.check_sass(_fake_build(cs))
        assert set(out["flash_attention_bwd_dq"]) == {"D=64", "D=128"}
        assert out["flash_attention_bwd_dq"]["D=128"]["hgmma"] == 4
        for name in ("flash_attention_small", "flash_attention_bwd_small"):
            assert set(out[name]) == {"D=16", "D=32"}
            assert out[name]["D=16"]["hgmma"] == 4
        assert out["lstm_backward"]["spill_stores"] == 0
        assert set(out["q_matmul_prefill"]) == {"<256,2>", "<64,1>"}
        assert out["q_matmul_prefill"]["<256,2>"]["hgmma"] == 4
        assert set(out["lstm_forward"]) == {"<128,4>", "<32,2>"}
        assert set(out["lstm_backward_scan"]) == {"<bf16,true>",
                                                  "<f32,false>"}
        return
    if fault == "no_hgmma":
        fake = _fake_build(cs, hgmma=0)
    elif fault == "no_hgmma_qmm":
        fake = _fake_build(cs, no_hgmma_in="qmm_prefill_wgmma_kernel")
    elif fault == "no_hgmma_small":
        fake = _fake_build(cs, no_hgmma_in="fa_fwd_small_kernel")
    else:
        fake = _fake_build(cs, spilled=fault)
    with pytest.raises(AssertionError):
        cs.check_sass(fake)
