"""The vehicle-asset YAML reader (core/params.parse_yaml) against PyYAML."""

import glob
import os

import pytest

from pyflyt_tpu.core.params import ASSET_DIR, load_vehicle_yaml, parse_yaml

FILES = sorted(glob.glob(os.path.join(ASSET_DIR, "vehicles", "*.yaml")))


@pytest.mark.parametrize("path", FILES, ids=os.path.basename)
def test_matches_pyyaml_on_bundled_assets(path):
    yaml = pytest.importorskip("yaml")
    with open(path) as f:
        text = f.read()
    assert parse_yaml(text) == yaml.safe_load(text)


def test_scalar_resolution_matches_pyyaml():
    yaml = pytest.importorskip("yaml")
    text = (
        "i: 18\nneg: -2\nf: 3.16e-10\ng: 0.5\nnoexp: 1e-5\nt: true\n"
        "o: off\nn: ~\ns: cf2x\nq: 'a b'\ndq: \"c # d\"  # comment\n"
        "nested: [[1, 2.5], [3, -4]]\nempty: []\n"
        "items:\n  - name: w\n    span: 0.3\n  - [1, 2]\n  - 7\n"
        "seq_same_indent:\n- 1\n- 2\n"
    )
    assert parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize(
    "text, lineno",
    [
        ("a: {x: 1}", 1),
        ("a: 1\nb: &anchor 2", 2),
        ("a: |\n  block", 1),
        ("a:\n\tb: 1", 2),
        ("a: [1, 2", 1),
        ("a: 1\n   b: 2", 2),
        ("a: 1\na: 2", 2),
        ("---\na: 1", 1),
    ],
)
def test_unsupported_yaml_raises_with_line(text, lineno):
    with pytest.raises(ValueError, match=f"line {lineno}"):
        parse_yaml(text)


def test_user_model_dir(tmp_path):
    (tmp_path / "mine.yaml").write_text("mass: 0.5  # kg\narms: [1, 2]\n")
    assert load_vehicle_yaml("mine", str(tmp_path)) == {
        "mass": 0.5, "arms": [1, 2],
    }
