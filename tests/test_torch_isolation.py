"""The port stands alone: importing every module of tpu_bootstrap_torch
(and chip_smoke.py) pulls in neither JAX nor the JAX package, and the
kernel module imports without nvcc or a card, building or launching
only when a CUDA tensor asks for a kernel."""

import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import tpu_bootstrap_torch
from tpu_bootstrap_torch.workload import kernels

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


def _port_modules() -> list:
    names = ["tpu_bootstrap_torch"]
    for info in pkgutil.walk_packages(tpu_bootstrap_torch.__path__,
                                      "tpu_bootstrap_torch."):
        names.append(info.name)
    return names


def test_port_modules_cover_the_slice():
    names = set(_port_modules())
    for mod in ("telemetry", "workload.bridge", "workload.model",
                "workload.quant", "workload.decode_attention",
                "workload.kernels", "workload.decode",
                "workload.speculative", "workload.serving",
                "workload.flash_attention", "workload.xent",
                "workload.faults", "workload.checkpoint", "workload.data",
                "workload.train", "workload.graphs", "workload.ingress",
                "workload.prng", "workload.lora", "workload.distill",
                "workload.quality", "workload.sharding",
                "workload.dryrun_mp", "workload.ring_attention",
                "workload.pipeline", "workload.router", "workload.fleetz",
                "nativelib", "fakeapi", "fakeadmission"):
        assert f"tpu_bootstrap_torch.{mod}" in names, mod


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('jax', 'jaxlib', 'tpu_bootstrap'))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


ENTRIES = {"router": "workload.router", "fleetz": "workload.fleetz",
           "fakeapi": "fakeapi"}


@pytest.mark.parametrize("module", sorted(ENTRIES))
def test_fleet_entries_run_where_jax_cannot_import(module, tmp_path):
    """``python -m tpu_bootstrap_torch.workload.{router,fleetz} --help`` and
    ``python -m tpu_bootstrap_torch.fakeapi --help`` in a process whose
    ``import jax`` (and ``jaxlib``) raises."""
    for name in ("jax", "jaxlib"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(
            "raise ImportError('no JAX on this machine')\n")
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(tmp_path), str(ROOT)])}
    out = subprocess.run(
        [sys.executable, "-m", f"tpu_bootstrap_torch.{ENTRIES[module]}",
         "--help"], capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=env)
    assert out.returncode == 0, out.stderr
    assert f"python -m tpu_bootstrap_torch.{ENTRIES[module]}" in out.stdout


def test_kernel_wrappers_refuse_host_tensors():
    x = torch.randn(2, 16)
    q = torch.zeros(16, 8, dtype=torch.int8)
    s = torch.ones(8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.int8_matmul(x, q, s)
    kq = torch.zeros(3, 16, 2, 16, dtype=torch.int8)
    ks = torch.ones(3, 16, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.paged_attention(torch.randn(1, 2, 16), kq, ks, kq, ks,
                                torch.ones(1, 1, dtype=torch.int32),
                                torch.ones(1, dtype=torch.int32))
    q = torch.randn(1, 8, 4, 64)
    kv = torch.randn(1, 8, 2, 64)
    rows = torch.zeros(1, 8, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.flash_fwd(q, kv, kv, 0.125, True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.flash_dq(q, kv, kv, q, rows, rows, 0.125, True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.flash_dkv(q, kv, kv, q, rows, rows, 0.125, False)
    xe = torch.randn(2, 3, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.int8_expert_matmul(xe, torch.zeros(2, 16, 8, dtype=torch.int8),
                                   torch.ones(2, 1, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.int4_matmul(x, torch.zeros(8, 8, dtype=torch.uint8),
                            torch.ones(2, 8), 8, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.int4_expert_matmul(xe, torch.zeros(2, 8, 8, dtype=torch.uint8),
                                   torch.ones(2, 2, 8), 8, 16)
    kc = torch.zeros(1, 16, 2, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.decode_attention(torch.randn(1, 2, 16), kc,
                                 torch.ones(1, 16, 2), kc,
                                 torch.ones(1, 16, 2),
                                 torch.ones(16, dtype=torch.bool))
    assert set(kernels.LAUNCHES) == {
        "int8_matmul", "int8_expert_matmul", "int4_matmul",
        "int4_expert_matmul", "paged_attention", "decode_attention",
        "flash_fwd", "flash_dq", "flash_dkv"}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()
    assert not (tmp_path / "kernels").exists()


def test_library_name_follows_the_sources():
    assert kernels.sources() == sorted(
        (ROOT / "tpu_bootstrap_torch/workload/csrc").glob("*.cu"))
    name = kernels.library_path().name
    assert name == f"libtpubc_torch_kernels-{kernels.source_digest()}.so"
    assert kernels.library_path().parent == ROOT / "build" / "kernels"


def test_smem_rule_mirrors_the_kernel_layout():
    # bs=64, D=64, one query head per KV head: the decode model's block. q,
    # scores, four warps' p . v sums, row maxima and row sums, a chunk's
    # partial (acc, then (m, l)) in f32, then two ring slots of K, V (64 x
    # 64 bytes), their scales and the admitted flags.
    assert kernels.paged_attention_smem_bytes(64, 64, 1) == (
        256 + 256 + 4 * 256 + 32 + 272 + 2 * (2 * 64 * 64 + 2 * 256 + 64))
    assert kernels.paged_attention_smem_bytes(64, 64, 4) < (
        kernels.DECODE_SMEM_LIMIT)
    # K5 shares the layout at its fixed chunk of 64 positions.
    assert kernels.decode_attention_smem_bytes(64, 1) == (
        kernels.paged_attention_smem_bytes(kernels.DECODE_CHUNK, 64, 1))
    # A query group of 4 heads: four times the f32 rows, the same slots.
    assert kernels.decode_attention_smem_bytes(64, 4) == (
        1024 + 1024 + 4 * 1024 + 128 + 1056 + 2 * (2 * 64 * 64 + 2 * 256 + 64))


def test_flash_smem_fits_a_cta_and_follows_the_tiles():
    # Every (kernel, head dim, dtype) the flash kernels instantiate fits
    # the shared memory an H100 gives one CTA (232,448 bytes).
    for role in kernels.FLASH_ROLES:
        for d in kernels.FLASH_HEAD_DIMS:
            for dt in (torch.float32, torch.bfloat16):
                assert 0 < kernels.flash_smem_bytes(role, d, dt) <= 232_448
    # f32 (CUDA cores): 64 x 64 tiles staged as (64, D + 4) f32 with a
    # (64, 72) score tile, D = 64.
    assert kernels.flash_tiles("fwd", 64, torch.float32) == (64, 64)
    assert kernels.flash_smem_bytes("fwd", 64, torch.float32) == (
        4 * (3 * 64 * 68 + 64 * 72))
    assert kernels.flash_smem_bytes("dkv", 64, torch.float32) == (
        4 * (4 * 64 * 68 + 2 * 64 * 72 + 2 * 64))
    # bf16 (tensor cores), D = 64: the CTA's own 128-row bf16 tiles, a
    # two-stage ring of the step's tiles, five 8-byte barriers and 1024
    # bytes to align the start.
    tiles = {role: kernels.flash_tiles(role, 64, torch.bfloat16)
             for role in kernels.FLASH_ROLES}
    assert tiles == {"fwd": (128, 64), "dq": (128, 32), "dkv": (128, 64)}
    rest = 5 * 8 + 1024
    assert kernels.flash_smem_bytes("fwd", 64, torch.bfloat16) == (
        128 * 64 * 2 + 2 * 2 * 64 * 64 * 2 + rest)  # Q; K, V
    assert kernels.flash_smem_bytes("dq", 64, torch.bfloat16) == (
        2 * 128 * 64 * 2 + 2 * 2 * 32 * 64 * 2 + rest)  # Q, dO; K, V
    assert kernels.flash_smem_bytes("dkv", 64, torch.bfloat16) == (
        2 * 128 * 64 * 2 + 2 * (2 * 64 * 64 * 2 + 2 * 64 * 4) + rest)
    # Steps are whole 16-row wgmma reductions; D = 128 narrows them.
    for role in kernels.FLASH_ROLES:
        for d in kernels.FLASH_HEAD_DIMS:
            rows, step = kernels.flash_tiles(role, d, torch.bfloat16)
            assert rows == 128 and step % 16 == 0
    assert kernels.flash_tiles("dkv", 128, torch.bfloat16) == (128, 32)
    with pytest.raises(ValueError, match="head_dim 48"):
        kernels.flash_tiles("fwd", 48, torch.bfloat16)


def test_build_report_reads_registers_spills_and_hgmma():
    # chip_smoke's build phase reads ptxas's -v lines and cuobjdump's SASS
    # for each bf16 flash kernel; an f32 kernel is left out.
    import chip_smoke

    log = ("ptxas info    : Compiling entry function '_ZN11tpubc_flash21flash_"
           "fwd_sm90_kernelILi64EEEv14CUtensorMap_st' for 'sm_90a'\n"
           "ptxas info    : Function properties for _ZN11tpubc_flash21flash_"
           "fwd_sm90_kernelILi64EEEv14CUtensorMap_st\n"
           "    40 bytes stack frame, 44 bytes spill stores, 68 bytes spill "
           "loads\n"
           "ptxas info    : Used 96 registers, used 1 barriers\n"
           "ptxas info    : Compiling entry function '_ZN16flash_fwd_kernelIf"
           "Li64EEEvPKT_' for 'sm_90a'\n"
           "ptxas info    : Used 128 registers, used 1 barriers\n")
    sass = ("\tFunction : _ZN11tpubc_flash21flash_fwd_sm90_kernelILi64EEEv14C\n"
            "  /*26e0*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR56], RZ, !UPT ;\n"
            "  /*2850*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR56], R24 ;\n"
            "\tFunction : _ZN16flash_fwd_kernelIfLi64EEEvPKT_\n"
            "  /*0100*/  FFMA R1, R2, R3, R4 ;\n")
    assert chip_smoke._sm90_report(log, sass) == {
        "flash_fwd_sm90<64>": {"hgmma": 2, "spill_stores": 44,
                               "spill_loads": 68, "registers": 96}}


def _quant_build_report(bits: int) -> tuple:
    """ptxas's lines and the SASS of every instantiation of the quantized
    matmul kernel in one format (x dtype x (dense, expert) x (TMA, plain
    loads)) under its mangled name, and the report chip_smoke must read
    from them, under short names."""
    mangled = ("_ZN10quant_sm9024quant_matmul_sm90_kernelILi{}E{}Lb{}ELb{}EEEv"
               "14CUtensorMap_stS{}_NS_4ArgsE")
    log, sass, want = "", "", {}
    for x, xs, sub in (("13__nv_bfloat16", "bf16", 2), ("f", "f32", 1)):
        for ex in (0, 1):
            for tma in (0, 1):
                name = mangled.format(bits, x, ex, tma, sub)
                log += (f"ptxas info    : Compiling entry function '{name}' "
                        "for 'sm_90a'\n"
                        "    0 bytes stack frame, 0 bytes spill stores, 0 "
                        "bytes spill loads\n"
                        "ptxas info    : Used 90 registers, used 1 barriers\n")
                sass += (f"\tFunction : {name}\n"
                         "  /*0100*/  HGMMA.64x8x16.F32.BF16 R24, R40, "
                         "gdesc[UR4], R24 ;\n")
                short = (f"int{bits}_sm90<{xs}, {('dense', 'expert')[ex]}, "
                         f"{('ldg', 'tma')[tma]}>")
                want[short] = {"hgmma": 1, "spill_stores": 0,
                               "spill_loads": 0, "registers": 90}
    return log, sass, want


def test_build_report_names_every_int4_instantiation():
    # K6/K6e: the int4 instantiations of the quantized matmul kernel, each
    # read from ptxas's lines and its SASS by its mangled name.
    import chip_smoke

    log, sass, want = _quant_build_report(4)
    assert chip_smoke._sm90_report(log, sass) == want
    assert 2 * len(want) + 9 == chip_smoke.SM90_KERNELS


def test_build_report_names_every_int8_instantiation():
    # K1/K1e: the int8 instantiations, beside the int4 ones in one build;
    # a kernel whose wgmmas ptxas serialized (C7520) is marked.
    import chip_smoke

    log4, sass4, want4 = _quant_build_report(4)
    log8, sass8, want8 = _quant_build_report(8)
    assert len(want8) == 8 and not set(want8) & set(want4)
    assert chip_smoke._sm90_report(log8 + log4, sass4 + sass8) == {
        **want4, **want8}
    name = next(line.split("'")[1] for line in log8.splitlines()
                if "Compiling" in line)
    serialized = (f"ptxas info    : (C7520) Potential Performance Loss: "
                  f"wgmma.mma_async instructions are serialized due to the "
                  f"presence of Extern calls in the function '{name}'\n")
    report = chip_smoke._sm90_report(serialized + log8, sass8)
    assert report["int8_sm90<bf16, dense, ldg>"]["serialized"] is True
    assert sum("serialized" in r for r in report.values()) == 1


def test_build_report_names_every_decode_attention_kernel():
    # K2 (head dim and block 64 compiled in, and general) and K5, in bf16
    # and f32: each read from ptxas's lines by its mangled name.
    import chip_smoke

    log, want = "", {}
    kernels_ = [("paged", "Li64ELi64E", ", 64, 64"),
                ("paged", "Li0ELi0E", ", 0, 0"), ("decode", "", "")]
    for kind, consts, short in kernels_:
        for x, xs in (("13__nv_bfloat16", "bf16"), ("f", "f32")):
            name = (f"_ZN51_GLOBAL__N__6d377c48_18_{kind}_attention_cu_fe4ee1"
                    f"0722{kind}_attention_kernelI{x}{consts}EEvN16decode_"
                    "attention4ArgsEPKiS4_i")
            log += (f"ptxas info    : Compiling entry function '{name}' for "
                    "'sm_90a'\n"
                    f"ptxas info    : Function properties for {name}\n"
                    "    0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                    "spill loads\n"
                    "ptxas info    : Used 64 registers, used 1 barriers\n")
            want[f"{kind}_attention<{xs}{short}>"] = {
                "spill_stores": 0, "spill_loads": 0, "registers": 64}
    assert chip_smoke._ptxas_report(log, chip_smoke._decode_name) == want
    assert len(want) == chip_smoke.DECODE_KERNELS
