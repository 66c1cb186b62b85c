"""``tools/build_docs_torch.py``, the docs generator of the port.

It renders ``geomloss_tpu_torch``'s docstrings into the pages of
``tools/build_docs.py`` (same slugs, same tutorials, from
``examples_torch/``), with the standard library only and without JAX.
"""

import ast
import importlib.util
import pathlib
import re

import geomloss_tpu_torch
import geomloss_tpu_torch.ot
import geomloss_tpu_torch.parallel

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "tools" / "build_docs_torch.py"


def _load():
    spec = importlib.util.spec_from_file_location("build_docs_torch", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _render(tmp_path):
    docs = _load()
    docs.main([str(tmp_path)])
    return docs, {p.relative_to(tmp_path).as_posix(): p.read_text() for p in tmp_path.rglob("*.html")}


def test_every_exported_name_is_on_a_page(tmp_path):
    _, pages = _render(tmp_path)
    text = "\n".join(pages.values())
    names = {*geomloss_tpu_torch.__all__, *geomloss_tpu_torch.ot.__all__, *geomloss_tpu_torch.parallel.__all__}
    missing = [n for n in sorted(names) if n not in text]
    assert not missing, missing
    # The callables each get their own entry:
    entries = set(re.findall(r'<h3 id="([^"]+)">', text))
    callables = {n for n in names if n not in ("ot", "__version__")}
    assert callables <= entries, sorted(callables - entries)


def test_pages_mirror_the_jax_generator(tmp_path):
    """The slugs of ``tools/build_docs.py``'s pages; the ops page lists the
    CUDA wrappers where the JAX one lists the Pallas kernels; the tutorials
    render the same six scripts from ``examples_torch/``."""
    docs, pages = _render(tmp_path)
    slugs = [slug for slug, _, _ in docs.API_PAGES]
    assert slugs == ["samples-loss", "ot-api", "solvers", "ops", "parallel", "utils"]
    assert {f"api/{s}.html" for s in slugs} | {"api/index.html", "index.html", "tutorials/index.html"} <= set(pages)

    def sections(slug):
        return re.findall(r"<h2><code>([^<]+)</code></h2>", pages[f"api/{slug}.html"])

    ops = [m.rsplit(".", 1)[1] for m in sections("ops")]
    assert ops == ["costs", "softmin", "grid", "cuda_kernels", "cuda_block_sparse", "block_sparse", "spatial"]
    parallel = [m.rsplit(".", 1)[1] for m in sections("parallel")]
    assert parallel == ["ring", "multiscale_sharded"]
    for fname, _ in docs.TUTORIALS:
        assert (ROOT / "examples_torch" / fname).is_file()
        assert f"examples_torch/{fname}" in pages[f"tutorials/{fname[:-3]}.html"]
        assert f'href="{fname[:-3]}.html"' in pages["tutorials/index.html"]
    assert len(docs.TUTORIALS) == 6


def test_the_script_imports_neither_jax_nor_the_jax_package():
    tree = ast.parse(SCRIPT.read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "geomloss_tpu", "optax"}, roots
    assert "importlib" in roots and "inspect" in roots
    # Each module the pages render is the port's:
    docs = _load()
    modules = [m for _, _, specs in docs.API_PAGES for m, _ in specs]
    assert all(m == "geomloss_tpu_torch" or m.startswith("geomloss_tpu_torch.") for m in modules)
