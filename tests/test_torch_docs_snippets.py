"""The usage pages of docs/ run against the port, on the CPU.

The same pages as tests/test_docs_snippets.py (``docs/usage/*.md`` and
``docs/physics/*.md``; 18 pages hold 127 ``python`` blocks), each run as one
namespace from top to bottom with ``optrace_tpu`` read as
``optrace_tpu_torch``, ``device=None`` read as the CPU
(``test_torch_common.cpu_default_device``) and the blocks that need the JAX
API in their torch forms (``chip_smoke.DOCS_TORCH_FORMS``, which the card's
phase ``docs`` runs too). A block that raises fails its page. ``docs/``
itself is left as it is. This file imports no JAX.
"""

import contextlib
import os

import matplotlib
import pytest

import chip_smoke
import optrace_tpu_torch as otp
from test_torch_common import cpu_default_device, closing_new_figures

matplotlib.use("Agg")

PAGES = [(os.path.basename(p), chip_smoke.docs_blocks(p)) for p in chip_smoke.docs_pages()]
BLOCKS = {page: blocks for page, blocks in PAGES if blocks}
GUI_RUNS = 3        # the JAX package's GUI page is flaky (stale widget callbacks); the port's runs three times


def port_blocks(page):
    return [(i, chip_smoke.docs_port_block(page, i, src)) for i, src in enumerate(BLOCKS[page])]


def run_page(page, blocks, where):
    """The blocks of ``page`` in one namespace in the directory ``where``,
    on the CPU, with the global options restored and the figures the page
    opened closed after it; ``parallel.md`` in a gloo process group of one
    rank. Returns the devices of what the page left (``docs_devices``)."""
    os.chdir(where)
    group = chip_smoke.one_rank_group("gloo", str(where)) if page == "parallel.md" \
        else contextlib.nullcontext()
    with cpu_default_device(), chip_smoke.kept_global_options(otp.global_options), group, \
            closing_new_figures():
        ns = chip_smoke.run_docs_blocks(page, blocks)
        return chip_smoke.docs_devices(otp, ns)


def test_pages_and_blocks_counted():
    """18 pages with blocks and 127 blocks, as the card's phase expects."""
    assert len(BLOCKS) == chip_smoke.DOCS_PAGES_WITH_BLOCKS
    assert sum(len(b) for b in BLOCKS.values()) == chip_smoke.DOCS_BLOCKS


def test_the_forms_are_the_blocks_that_need_jax():
    """The torch forms stand for exactly the blocks that name jax, jnp or
    pallas, and ``parallel.md`` [2] (a JAX key through
    ``RenderCheckpoint.key``); each keeps its block's asserts, and no
    block as it runs names jax or jnp."""
    need = {(page, i) for page, blocks in BLOCKS.items() for i, src in enumerate(blocks)
            if chip_smoke.DOCS_JAX.search(src)}
    assert len(need) == 10
    assert set(chip_smoke.DOCS_TORCH_FORMS) == need | {("parallel.md", 2)}
    for (page, i), form in chip_smoke.DOCS_TORCH_FORMS.items():
        assert form != BLOCKS[page][i] and form.count("assert ") == BLOCKS[page][i].count("assert "), (page, i)
    for page in BLOCKS:
        assert not any(chip_smoke.DOCS_JAX.search(src) for _, src in port_blocks(page)), page


@pytest.mark.parametrize("page", sorted(BLOCKS))
def test_page_runs_against_the_port(page, tmp_path, monkeypatch):
    """Every block of the page, in order, in one namespace; what the page
    left (raytracers, their stored traces, images, tensors) lies on the
    CPU. The GUI page runs three times in a row."""
    monkeypatch.chdir(tmp_path)
    blocks = port_blocks(page)
    for k in range(GUI_RUNS if page == "gui.md" else 1):
        where = tmp_path / f"run{k}"
        where.mkdir()
        devices = run_page(page, blocks, where)
        assert all(d == {"cpu"} for d in devices.values()), devices


def test_the_card_runs_blocks_up_to_the_first_drawing():
    """The card machine has no matplotlib: phase ``docs`` runs each page up
    to its first block that draws, and names every other block with its
    reason."""
    for page, blocks in BLOCKS.items():
        ran, why = chip_smoke.docs_card_blocks(blocks)
        assert len(ran) + len(why) == len(blocks) and sorted(why) == list(range(len(ran), len(blocks)))
        assert not any(chip_smoke.DOCS_DRAWING.search(src) for src in ran), page
        assert all(w for w in why.values())
    assert not chip_smoke.docs_card_blocks(BLOCKS["raytracer.md"])[1]
    assert chip_smoke.docs_card_blocks(BLOCKS["gui.md"])[0] == []


def test_the_device_rule_is_restored():
    """Inside the context ``device=None`` is the CPU in every module of the
    port that bound the rule; after it each has its own function again, and
    without a card ``device=None`` raises as before."""
    import sys
    import torch
    from optrace_tpu_torch.utils import device
    real = device.resolve_device
    with cpu_default_device() as rule:
        bound = [mod for name, mod in sys.modules.items()
                 if name.split(".")[0] == "optrace_tpu_torch" and getattr(mod, "resolve_device", None) is rule]
        assert {m.__name__ for m in bound} >= {"optrace_tpu_torch", "optrace_tpu_torch.utils.device",
                                               "optrace_tpu_torch.tracer.raytracer",
                                               "optrace_tpu_torch.parallel.render"}
        assert otp.make_generator(0).device.type == "cpu"
        assert otp.Raytracer(outline=[-1, 1, -1, 1, -1, 1]).device.type == "cpu"
    assert all(mod.resolve_device is real for mod in bound)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            otp.Raytracer(outline=[-1, 1, -1, 1, -1, 1])
