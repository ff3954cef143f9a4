"""The port's knob catalog (``docs/torch_utilities.md``) against its knob
registry (``torchsnapshot_tpu_torch/utils/knobs.py``), as the JAX
package's analyzer holds ``docs/utilities.md`` against its own (TSA302,
TSA303), and the page through ``docs/build_docs.py``'s checks."""

import importlib.util
import os
import re

import pytest

from torchsnapshot_tpu_torch.utils import knobs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CATALOG = "docs/torch_utilities.md"
_NAME = re.compile(r"TSS_TORCH_([A-Z0-9_]*[A-Z0-9])")


def _read(relpath):
    with open(os.path.join(REPO, relpath), encoding="utf-8") as f:
        return f.read()


def _registry():
    with open(knobs.__file__) as f:
        return set(re.findall(r'_P \+ "([A-Z0-9_]+)"', f.read()))


def _catalog_rows():
    return set(re.findall(r"^\| `TSS_TORCH_([A-Z0-9_]+)` \|", _read(CATALOG), re.M))


def test_every_registry_knob_is_in_the_catalog():
    registry = _registry()
    assert len(registry) == 65
    assert sorted(registry - _catalog_rows()) == []


@pytest.mark.parametrize("relpath", [CATALOG, "README.md"])
def test_every_named_knob_is_in_the_registry(relpath):
    named = set(_NAME.findall(_read(relpath)))
    assert named and sorted(named - _registry()) == []


def test_the_catalog_passes_the_docs_checks():
    spec = importlib.util.spec_from_file_location("build_docs", os.path.join(REPO, "docs", "build_docs.py"))
    build_docs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build_docs)
    text = _read(CATALOG)
    assert "```python" in text and "](" in text
    assert build_docs.check_snippets(CATALOG, text) == []
    assert build_docs.check_links(CATALOG, text) == []
