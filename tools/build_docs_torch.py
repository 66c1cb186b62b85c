"""Generate the HTML documentation for geomloss_tpu_torch.

The twin of ``tools/build_docs.py`` for the PyTorch and CUDA port: the
same standard-library builder (``inspect`` and docstrings to HTML), the
same API pages under the same slugs and the same six tutorials, rendered
from ``geomloss_tpu_torch``'s docstrings and ``examples_torch/``. It
imports neither JAX nor the JAX package, so it keeps its own copy of the
page, style and signature code. Importing the port builds no kernel, so
it needs neither a GPU nor ``nvcc``.

Usage:  python tools/build_docs_torch.py  [outdir]      (default: docs/html_torch)
"""

import html
import importlib
import inspect
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


# --- what to document -------------------------------------------------------

API_PAGES = [
    # (page slug, page title, [(module, [names] | None for __all__)])
    (
        "samples-loss",
        "SamplesLoss and friends (the PyTorch API)",
        [
            ("geomloss_tpu_torch", ["SamplesLoss", "ImagesLoss", "VolumesLoss",
                                    "ImagesBarycenter", "sinkhorn_divergence"]),
        ],
    ),
    (
        "ot-api",
        "The ot.* API (POT-style solvers)",
        [
            ("geomloss_tpu_torch.ot", None),
        ],
    ),
    (
        "solvers",
        "Abstract solvers (annealing, Sinkhorn loops, barycenters)",
        [
            ("geomloss_tpu_torch.solvers.annealing", None),
            ("geomloss_tpu_torch.solvers.sinkhorn_loop", None),
            ("geomloss_tpu_torch.solvers.sinkhorn_ot", None),
            ("geomloss_tpu_torch.solvers.barycenters", None),
            ("geomloss_tpu_torch.solvers.unbalanced", None),
        ],
    ),
    (
        "ops",
        "GPU compute primitives (costs, softmins, CUDA kernels)",
        [
            ("geomloss_tpu_torch.ops.costs", None),
            ("geomloss_tpu_torch.ops.softmin", None),
            ("geomloss_tpu_torch.ops.grid", None),
            ("geomloss_tpu_torch.ops.cuda_kernels", None),
            ("geomloss_tpu_torch.ops.cuda_block_sparse", None),
            ("geomloss_tpu_torch.ops.block_sparse", None),
            ("geomloss_tpu_torch.ops.spatial", None),
        ],
    ),
    (
        "parallel",
        "Multi-GPU parallelism (ranks, ring Sinkhorn, sharded multiscale)",
        [
            ("geomloss_tpu_torch.parallel.ring", None),
            ("geomloss_tpu_torch.parallel.multiscale_sharded", None),
        ],
    ),
    (
        "utils",
        "Utilities (validation, caching, typing, profiling, numpy interop)",
        [
            ("geomloss_tpu_torch.utils.validation", None),
            ("geomloss_tpu_torch.utils.cache", None),
            ("geomloss_tpu_torch.utils.typing", None),
            ("geomloss_tpu_torch.utils.profiling", None),
            ("geomloss_tpu_torch.utils.interop", None),
        ],
    ),
]

TUTORIALS = [
    ("plot_optimal_transport_2D.py", "Optimal Transport in 2D"),
    ("plot_gradient_flows_2D.py", "Wasserstein gradient flows"),
    ("plot_epsilon_scaling.py", "Epsilon-scaling and annealing"),
    ("plot_wasserstein_barycenters_2D.py", "Wasserstein barycenters on images"),
    ("plot_kernel_truncation.py", "Multiscale solvers and kernel truncation"),
    ("plot_interpolation_3D.py", "Shape interpolation in 3D"),
]

CSS = """
body { font-family: Georgia, serif; max-width: 60em; margin: 2em auto;
       padding: 0 1em; color: #1a1a1a; line-height: 1.45; }
h1, h2, h3 { font-family: Helvetica, Arial, sans-serif; }
h1 { border-bottom: 2px solid #555; padding-bottom: .2em; }
code, pre { font-family: "SF Mono", Menlo, Consolas, monospace;
            background: #f6f6f4; }
pre { padding: .8em 1em; overflow-x: auto; border-left: 3px solid #bbb;
      font-size: .85em; }
.sig { background: #eef2f6; border-left: 3px solid #47a; padding: .5em .8em;
       font-family: Menlo, Consolas, monospace; font-size: .9em;
       white-space: pre-wrap; }
.docstring { margin: .5em 0 2em 1em; white-space: pre-wrap;
             font-size: .95em; }
nav a { margin-right: 1.2em; }
.member { margin-top: 2em; }
footer { margin-top: 4em; font-size: .8em; color: #777;
         border-top: 1px solid #ddd; padding-top: 1em; }
"""


def page(title, body, depth=0):
    rel = "../" * depth
    return f"""<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<title>{html.escape(title)} — geomloss_tpu_torch</title>
<style>{CSS}</style></head><body>
<nav><a href="{rel}index.html">geomloss_tpu_torch</a>
<a href="{rel}api/index.html">API reference</a>
<a href="{rel}tutorials/index.html">Tutorials</a></nav>
<h1>{html.escape(title)}</h1>
{body}
<footer>geomloss_tpu_torch — the PyTorch and CUDA port of geomloss_tpu
(Sinkhorn divergences, MMDs and Wasserstein barycenters with PyTorch and
hand-written CUDA kernels for NVIDIA Hopper). Generated by
tools/build_docs_torch.py.</footer>
</body></html>"""


def public_members(mod, names):
    if names is None:
        names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    out = []
    for n in names:
        obj = getattr(mod, n, None)
        if obj is None or inspect.ismodule(obj):
            continue
        out.append((n, obj))
    return out


def signature(obj):
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return ""


def render_member(name, obj):
    doc = inspect.getdoc(obj) or "(undocumented)"
    kind = "class" if inspect.isclass(obj) else "def"
    body = [
        f'<div class="member"><h3 id="{html.escape(name)}">'
        f"{html.escape(name)}</h3>",
        f'<div class="sig">{kind} {html.escape(name)}{html.escape(signature(obj))}</div>',
        f'<div class="docstring">{html.escape(doc)}</div>',
    ]
    if inspect.isclass(obj):
        for mn, m in sorted(vars(obj).items()):
            if mn.startswith("_") or not callable(m):
                continue
            mdoc = inspect.getdoc(m)
            if not mdoc:
                continue
            body.append(
                f'<div class="sig">{html.escape(name)}.{html.escape(mn)}'
                f"{html.escape(signature(m))}</div>"
                f'<div class="docstring">{html.escape(mdoc)}</div>'
            )
    body.append("</div>")
    return "\n".join(body)


def build_api(outdir):
    apidir = outdir / "api"
    apidir.mkdir(parents=True, exist_ok=True)
    toc = []
    for slug, title, specs in API_PAGES:
        sections = []
        for modname, names in specs:
            mod = importlib.import_module(modname)
            moddoc = inspect.getdoc(mod) or ""
            sections.append(f"<h2><code>{html.escape(modname)}</code></h2>")
            if moddoc:
                sections.append(f'<div class="docstring">{html.escape(moddoc)}</div>')
            for n, obj in public_members(mod, names):
                sections.append(render_member(n, obj))
        (apidir / f"{slug}.html").write_text(page(title, "\n".join(sections), depth=1))
        toc.append(f'<li><a href="{slug}.html">{html.escape(title)}</a></li>')
    (apidir / "index.html").write_text(page("API reference", "<ul>" + "\n".join(toc) + "</ul>", depth=1))


def build_tutorials(outdir):
    tutdir = outdir / "tutorials"
    tutdir.mkdir(parents=True, exist_ok=True)
    toc = []
    for fname, title in TUTORIALS:
        src = (ROOT / "examples_torch" / fname).read_text()
        # Module docstring -> intro; the rest -> code block.
        intro, code = "", src
        stripped = src.lstrip()
        for q in ('"""', "'''"):
            if stripped.startswith(q):
                end = stripped.index(q, 3)
                intro = stripped[3:end]
                code = stripped[end + 3:]
                break
        body = (
            f'<div class="docstring">{html.escape(intro)}</div>'
            f"<h2>Source (<code>examples_torch/{html.escape(fname)}</code>)</h2>"
            f"<pre>{html.escape(code.strip())}</pre>"
        )
        slug = fname.replace(".py", "")
        (tutdir / f"{slug}.html").write_text(page(title, body, depth=1))
        toc.append(f'<li><a href="{slug}.html">{html.escape(title)}</a></li>')
    (tutdir / "index.html").write_text(
        page(
            "Tutorials",
            "<p>Rendered from the runnable scripts in <code>examples_torch/"
            "</code> (the 18 scripts of <code>examples/</code> under the same "
            "names, on <code>geomloss_tpu_torch</code> — see "
            "<code>examples_torch/README.md</code>).</p><ul>"
            + "\n".join(toc)
            + "</ul>",
            depth=1,
        )
    )


def build_index(outdir):
    import geomloss_tpu_torch

    names = ", ".join(f"<code>{html.escape(n)}</code>" for n in geomloss_tpu_torch.__all__)
    body = f"""
<p><b>Version {html.escape(geomloss_tpu_torch.__version__)}</b>
(<code>geomloss_tpu_torch.__version__</code>).
Sinkhorn divergences, Hausdorff divergences, kernel MMDs and debiased
Wasserstein barycenters between sampled measures, images and volumes, in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper
(<code>sm_90a</code>) built with <code>nvcc</code> at first use. The
package exports {names}.</p>
<ul>
<li><a href="api/index.html">API reference</a></li>
<li><a href="tutorials/index.html">Tutorials</a></li>
</ul>
<h2><code>geomloss_tpu_torch</code></h2>
<div class="docstring">{html.escape(inspect.getdoc(geomloss_tpu_torch) or "")}</div>
"""
    (outdir / "index.html").write_text(page("geomloss_tpu_torch", body))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    outdir = pathlib.Path(argv[0]) if argv else ROOT / "docs" / "html_torch"
    build_api(outdir)
    build_tutorials(outdir)
    build_index(outdir)
    n = len(list(outdir.rglob("*.html")))
    print(f"docs: wrote {n} HTML pages under {outdir}")


if __name__ == "__main__":
    main()
