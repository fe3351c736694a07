"""The kernels' build tag (``repro_torch.kernels._build._target``) follows
every file a library is compiled from: its ``csrc/<name>.cu`` and the
headers beside it (``csrc/*.cuh``), so an edited source or header never
loads a stale library.  On a temporary copy of ``csrc``; needs no nvcc.

Also: the device helpers K1, K3 and K5 share are defined once, in
``device_common.cuh``, which each of the three sources includes.
"""
import re
import shutil

import pytest

from repro_torch.kernels import _build

SHARED = ("fused_lookup", "overlay_probe", "inner_probe")
HELPERS = ("FULL_MASK", "ld_i32", "ld_i64", "group_lower_bound",
           "warp_lower_bound")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD", tmp_path / "_build")
    return src


def _tags():
    return {n: _build._target(n).name for n in SHARED + ("leaf_search",)}


def test_tag_is_stable(csrc):
    assert _tags() == _tags()
    assert all(t.startswith(f"lib{n}-") and t.endswith(".so")
               for n, t in _tags().items())


@pytest.mark.parametrize("name", SHARED)
def test_tag_follows_the_source(csrc, name):
    before = _tags()
    with open(csrc / f"{name}.cu", "a") as f:
        f.write("// edited\n")
    after = _tags()
    assert after[name] != before[name]
    assert {n: t for n, t in after.items() if n != name} == \
        {n: t for n, t in before.items() if n != name}


@pytest.mark.parametrize("edit", ["edited", "added", "removed"])
def test_tag_follows_the_headers(csrc, edit):
    before = _tags()
    if edit == "edited":
        with open(csrc / "device_common.cuh", "a") as f:
            f.write("// edited\n")
    elif edit == "added":
        (csrc / "extra.cuh").write_text("#pragma once\n")
    else:
        (csrc / "device_common.cuh").unlink()
    after = _tags()
    assert all(after[n] != before[n] for n in before)


def test_includes_are_headers_beside_the_sources():
    """Every local ``#include "..."`` names a ``csrc/*.cuh``, the files the
    tag hashes."""
    for src in _build.CSRC.glob("*.cu"):
        for inc in re.findall(r'#include\s+"([^"]+)"', src.read_text()):
            assert inc.endswith(".cuh") and "/" not in inc, (src.name, inc)
            assert (_build.CSRC / inc).is_file(), (src.name, inc)


@pytest.mark.parametrize("helper", HELPERS)
def test_shared_helpers_are_defined_once(helper):
    """K1, K3 and K5 include ``device_common.cuh``; none of the three
    copies a helper of it."""
    define = re.compile(rf"(constexpr unsigned {helper}\b|"
                        rf"__device__[^;{{]*\b{helper}\s*\()")
    files = ["device_common.cuh"] + [f"{n}.cu" for n in SHARED]
    where = [f for f in files
             if define.search((_build.CSRC / f).read_text())]
    assert where == ["device_common.cuh"]
    for name in SHARED:
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "device_common.cuh"' in text
