"""The port's config reader (`swarmmap_tpu_torch/utils/config.py`), which
parses the cv::FileStorage YAML subset without PyYAML, against the JAX
package's `load_opencv_yaml`, which runs PyYAML's `safe_load`.

Exact: every one of the 16 files under config/ gives the same dict, with
the same types, and so do `Settings.load` / `DatasetConfig.load`; and for
`key: value` lines drawn by hypothesis (plain scalars, single- and
double-quoted scalars, flow lists, comments, the "Key:value" spacing of
cv::FileStorage) the port gives PyYAML's value wherever PyYAML reads one
that lies in the subset (scalars and lists).  PyYAML resolves plain
scalars by YAML 1.1 rules: '1e-5' stays a string while '1.0e-5' is a
float, '0x10' is 16, '1_000' is 1000, 'yes' / 'off' are booleans.
"""
import dataclasses
import math
from pathlib import Path

import pytest
from hypothesis import HealthCheck, assume, given, settings, strategies as st

from swarmmap_tpu.utils import config as jconfig
from swarmmap_tpu_torch.utils import config as pconfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
CONFIG_FILES = sorted(str(p.relative_to(REPO)) for p in (REPO / "config").rglob("*.yaml"))


def _same(a, b) -> bool:
    """Equal values of the same types (NaN equal to NaN)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    return a == b


def test_sixteen_config_files():
    assert len(CONFIG_FILES) == 16, CONFIG_FILES


@pytest.mark.parametrize("name", CONFIG_FILES)
def test_config_file_matches_pyyaml(name):
    want = jconfig.load_opencv_yaml(REPO / name)
    got = pconfig.load_opencv_yaml(REPO / name)
    assert want and _same(got, want), (got, want)


@pytest.mark.parametrize("name", [n for n in CONFIG_FILES if "/settings/" in n])
def test_settings_load_matches_jax(name):
    want = jconfig.Settings.load(REPO / name)
    got = pconfig.Settings.load(REPO / name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("name", [n for n in CONFIG_FILES if "/settings/" not in n])
def test_dataset_config_load_matches_jax(name):
    assert dataclasses.asdict(pconfig.DatasetConfig.load(REPO / name)) == \
        dataclasses.asdict(jconfig.DatasetConfig.load(REPO / name))


YAML11 = [("1e-5", "1e-5"), ("1.0e-5", 1.0e-5), ("1.76187114e-05", 1.76187114e-05),
          (".5", 0.5), ("0x10", 16), ("1_000", 1000), ("017", 15), ("0b101", 5),
          ("1:30", 90), ("1:30.5", 90.5), ("yes", True), ("No", False), ("on", True),
          ("OFF", False), ("~", None), ("", None), ("null", None), ("-.Inf", -math.inf),
          ("+12", 12), ("-0", 0), ("1.", 1.0), ("0o17", "0o17"), ("y", "y"),
          ("'1e-5'", "1e-5"), ('"a\\tb"', "a\tb"), ("'it''s'", "it's"),
          ("[1, 'a', 2.5, [x, ~]]", [1, "a", 2.5, ["x", None]]), ("[a, b,]", ["a", "b"]),
          ("abc # comment", "abc"), ("a#b", "a#b")]


@pytest.mark.parametrize("text,want", YAML11, ids=[t for t, _ in YAML11])
def test_yaml11_resolution(tmp_path, text, want):
    """The YAML 1.1 traps, each as PyYAML reads it."""
    p = tmp_path / "s.yaml"
    p.write_text(f"%YAML:1.0\nKey:{text}\nOther: {text}\n")
    jgot = jconfig.load_opencv_yaml(p)
    assert _same(jgot, {"Key": want, "Other": want}), jgot
    assert _same(pconfig.load_opencv_yaml(p), jgot)


def test_outside_the_subset_raises(tmp_path):
    for text in ("a:\n  nested: 1\n", "a: {b: 1}\n", "a: &x 1\n", "a: |\n  x\n", "a: b: c\n"):
        p = tmp_path / "bad.yaml"
        p.write_text(text)
        with pytest.raises(ValueError, match="bad.yaml"):
            pconfig.load_opencv_yaml(p)


# hypothesis: single-line scalars of the characters YAML 1.1 resolution
# turns on, quoted scalars of any printable text, and flow lists of both
_PLAIN = st.one_of(
    st.text(alphabet="0123456789.-+_:eExXbBoOaAnNfFtTyYsSlLiIuU ~#'\"\\[],", max_size=12),
    st.from_regex(r"[-+]?[0-9_]{0,4}\.?[0-9_]{0,4}([eE][-+]?[0-9]{1,3})?", fullmatch=True),
    st.sampled_from([t for t, _ in YAML11] + ["2001-12-14", "2001-12-14t21:59:43.10-05:00",
                                              "2002-12-14 21:59:43.10", ".NaN", "=", "<<"]))
_PRINTABLE = st.characters(blacklist_categories=("Cc", "Cs", "Zl", "Zp"),
                           blacklist_characters="\x85")
_QUOTED = st.one_of(
    st.text(alphabet=_PRINTABLE, max_size=8).map(lambda s: "'" + s.replace("'", "''") + "'"),
    st.text(alphabet="ab \\\"ntx0u41/", max_size=10).map(lambda s: '"' + s + '"'))
_SCALAR = st.one_of(_PLAIN, _QUOTED)
_VALUE = st.one_of(
    _SCALAR,
    st.lists(_SCALAR, max_size=4).map(lambda xs: "[" + ", ".join(xs) + "]"),
    st.lists(st.lists(_SCALAR, max_size=2).map(lambda xs: "[" + ",".join(xs) + "]"),
             max_size=3).map(lambda xs: "[" + ", ".join(xs) + "]"))


def _flat(x) -> bool:
    return all(_flat(y) for y in x) if isinstance(x, list) else not isinstance(x, dict)


@settings(max_examples=400, deadline=None, suppress_health_check=list(HealthCheck))
@given(key=st.sampled_from(["Camera.fx", "K", "a_b", "1", "yes"]), value=_VALUE,
       sep=st.sampled_from([": ", ":", ":  "]), comment=st.sampled_from(["", " # c", "  #x"]))
def test_lines_match_pyyaml(tmp_path_factory, key, value, sep, comment):
    p = tmp_path_factory.mktemp("yaml") / "line.yaml"
    p.write_text(f"%YAML:1.0\n{key}{sep}{value}{comment}\n")
    try:
        want = jconfig.load_opencv_yaml(p)
    except Exception:  # noqa: BLE001  (PyYAML refuses the line: nothing to hold)
        assume(False)
    assume(all(_flat(v) for v in want.values()))
    got = pconfig.load_opencv_yaml(p)
    assert _same(got, want), (p.read_text(), got, want)
