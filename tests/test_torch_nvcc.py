"""The kernels' builder serves no stale library: the name it builds to
hashes the source and every header the source includes."""

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import nvcc  # noqa: E402
from repro_torch.kernels.flash_attention import build as fa_build  # noqa: E402
from repro_torch.kernels.flowhash import build as fh_build  # noqa: E402
from repro_torch.kernels.placement import build as pl_build  # noqa: E402
from repro_torch.kernels.ssd import build as ssd_build  # noqa: E402


def _family(tmp_path):
    """<tmp>/fam/csrc/k.cu including ../../common/a.cuh, which includes
    b.cuh beside it (and a system header, which is not followed)."""
    common = tmp_path / "common"
    common.mkdir()
    (common / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n'
                                  '#include <cuda.h>\nint a;\n')
    (common / "b.cuh").write_text("int b;\n")
    src = tmp_path / "fam" / "csrc" / "k.cu"
    src.parent.mkdir(parents=True)
    src.write_text('#include "../../common/a.cuh"\nint k;\n')
    return src, common


def test_sources_follow_quoted_includes(tmp_path):
    src, common = _family(tmp_path)
    assert nvcc.sources(src) == [src.resolve(), (common / "a.cuh").resolve(),
                                 (common / "b.cuh").resolve()]


@pytest.mark.parametrize("edited", ["k.cu", "a.cuh", "b.cuh"])
def test_editing_any_included_file_changes_the_library(tmp_path, edited):
    src, common = _family(tmp_path)
    before = nvcc.library_path(src)
    assert before.parent == tmp_path / "fam" / "_build"
    path = src if edited == "k.cu" else common / edited
    path.write_text(path.read_text() + "// edited\n")
    assert nvcc.library_path(src) != before


def test_both_hopper_kernels_hash_the_shared_header():
    header = (fa_build.SOURCE.parent.parent.parent / "csrc"
              / "hopper.cuh").resolve()
    for build in (fa_build, ssd_build):
        assert nvcc.sources(build.SOURCE)[1:] == [header]


def test_hash_and_placement_kernels_hash_the_shared_murmur():
    """The placement chain hashes ties with the flow-hash kernel's own
    murmur: both sources include one header, and editing it rebuilds
    both."""
    header = (fh_build.SOURCE.parent.parent.parent / "csrc"
              / "murmur.cuh").resolve()
    for build in (fh_build, pl_build):
        assert nvcc.sources(build.SOURCE)[1:] == [header]
