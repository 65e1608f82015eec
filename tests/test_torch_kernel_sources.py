"""The kernel sources' text edits and their build, checked without a card.

``chip_smoke.py`` builds copies of the CUDA sources with a fault planted in
each (``PLANTED``), ``scripts/flash_variants.py`` builds variants and
probes (``VARIANTS``, ``BWD_VARIANTS``), ``scripts/scan_variants.py`` those of
the scans and of the WKV-6 backward (``VARIANTS``) and ``scripts/scan_bwd_precision.py``
the scan backward with ``expf`` decays (``EXPF``) by the same text replacement.  Each
replaced text must stand in its source exactly once, or the copy would not be
the edit it claims to be; a copy that lies in ``build/`` still finds the
shared header ``csrc/hopper.cuh``, and an edit of that header must rebuild
every source.
"""

import sys
from pathlib import Path

import pytest

from repro_torch.kernels import _build

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "scripts")]

import chip_smoke  # noqa: E402
import flash_variants  # noqa: E402
import scan_bwd_precision  # noqa: E402
import scan_variants  # noqa: E402

TABLES = {**chip_smoke.PLANTED, **flash_variants.VARIANTS, **flash_variants.BWD_VARIANTS,
          **scan_variants.VARIANTS, "scan_bwd_expf": scan_bwd_precision.EXPF}
FLASH_SOURCES = ("flash_attention", "flash_attention_bwd")


@pytest.mark.parametrize("name", sorted(TABLES))
def test_each_edit_finds_its_text_once_and_changes_the_source(name):
    kernel = TABLES[name][0]
    before = (_build.CSRC / f"{kernel}.cu").read_text()
    after = chip_smoke.edited_source(name, TABLES[name])
    assert after != before


def test_an_edit_whose_text_is_missing_is_refused():
    with pytest.raises(AssertionError, match="exactly once"):
        chip_smoke.edited_source("absent", ("flash_attention_bwd", "no such text in the source", ""))


@pytest.mark.parametrize("kernel", FLASH_SOURCES)
def test_flash_sources_share_the_hopper_helpers(kernel):
    """Both flash sources take the mbarrier, TMA, wgmma and tensor-map helpers from one header."""
    src = (_build.CSRC / f"{kernel}.cu").read_text()
    header = (_build.CSRC / "hopper.cuh").read_text()
    assert '#include "hopper.cuh"' in src
    for definition in ("void mbar_wait(", "uint64_t sw128_desc(", "void wgmma_rs<256>(", "EncodeTiled encode_tiled()",
                       "CUresult make_map("):
        assert definition in header
        assert definition not in src


@pytest.mark.parametrize("kernel", ("flash_attention_bwd", "wkv6_bwd", "mamba_scan_bwd"))
def test_kernels_above_48_kb_share_the_opt_in_helper(kernel):
    """The kernels that take more than 48 KB of shared memory raise the limit through one helper, once per
    instantiation and device, and define no copy of it."""
    src = (_build.CSRC / f"{kernel}.cu").read_text()
    header = (_build.CSRC / "opt_in.cuh").read_text()
    assert '#include "opt_in.cuh"' in src
    for definition in ("cudaError_t opt_in_once(", "constexpr int MAX_DEVICES"):
        assert definition in header
        assert definition not in src
    assert "static bool done[MAX_DEVICES]" in src


def test_the_build_digest_covers_the_shared_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build._target("k")
    assert _build._target("k") == first
    (csrc / "h.cuh").write_text("// two\n")
    assert _build._target("k") != first


def test_the_nvcc_command_puts_csrc_on_the_include_path(tmp_path, monkeypatch):
    """A planted copy under build/ is compiled with csrc/ on the include path."""
    seen = {}

    def fake_run(cmd, **kwargs):
        seen["cmd"] = cmd
        Path(cmd[cmd.index("-o") + 1]).write_text("")
        return type("Proc", (), {"returncode": 0, "stdout": ""})()

    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    _build.compile_source(tmp_path / "copy.cu", tmp_path / "copy.so")
    cmd = seen["cmd"]
    assert cmd[cmd.index("-I") + 1] == str(_build.CSRC)
    assert (tmp_path / "copy.so").exists()


def test_the_tables_do_not_share_a_name():
    """One name, one edit: a table merged into TABLES must not hide another's entry."""
    tables = (chip_smoke.PLANTED, flash_variants.VARIANTS, flash_variants.BWD_VARIANTS, scan_variants.VARIANTS)
    assert sum(len(t) for t in tables) + 1 == len(TABLES)
