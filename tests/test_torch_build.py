"""The kernel build's cache key: each library of `ops/_build.py` lists every
header its source includes, directly or through another header, so that a
change to any of them rebuilds the library instead of loading a stale one
from `_build/`. CPU only: the sources are read, never compiled."""

import re
from pathlib import Path

import pytest

from sliders_tpu_torch.ops import _build

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def local_includes(source: Path) -> set:
    """Every file a source reaches through `#include "..."` lines, read
    transitively (system includes in <...> are not the package's)."""
    seen, todo = set(), [source]
    while todo:
        path = todo.pop()
        for name in _INCLUDE.findall(path.read_text()):
            header = (path.parent / name).resolve()
            if header not in seen:
                seen.add(header)
                todo.append(header)
    return seen


@pytest.mark.parametrize("name", sorted(_build.LIBRARIES))
def test_library_lists_exactly_the_headers_it_includes(name):
    source, headers, _ = _build.LIBRARIES[name]
    assert source.exists()
    assert {h.resolve() for h in headers} == local_includes(source), name


def test_every_csrc_file_belongs_to_a_library():
    used = set()
    for source, headers, _ in _build.LIBRARIES.values():
        used |= {source.resolve(), *(h.resolve() for h in headers)}
    assert {p.resolve() for p in _build.CSRC.iterdir() if p.suffix in (".cu", ".cuh")} == used


def test_header_reached_through_another_header_is_found(tmp_path):
    """A header included only by another header counts, so a library that
    left it out of its list would fail the test above."""
    (tmp_path / "a.cu").write_text('#include <cuda.h>\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text('#pragma once\n  #  include "c.cuh"\n')
    (tmp_path / "c.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    assert local_includes(tmp_path / "a.cu") == {(tmp_path / "b.cuh").resolve(),
                                                 (tmp_path / "c.cuh").resolve()}


def test_build_key_moves_with_every_listed_header(tmp_path, monkeypatch):
    """The library's path (its cache key) changes when any header changes."""
    src, hdr = tmp_path / "k.cu", tmp_path / "k.cuh"
    src.write_text('#include "k.cuh"\n')
    hdr.write_text("// one\n")
    monkeypatch.setitem(_build.LIBRARIES, "probe", (src, (hdr,), {}))
    before = _build.library_path("probe")
    hdr.write_text("// two\n")
    assert _build.library_path("probe") != before
