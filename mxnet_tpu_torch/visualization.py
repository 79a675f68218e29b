"""Network summaries.

Counterpart of ``mxnet_tpu/visualization.py`` (reference:
python/mxnet/visualization.py): ``print_summary`` of a Gluon block (a
per-layer parameter table) or a Symbol (its nodes), and ``plot_network``,
a graphviz graph of a Symbol, which falls back to the text summary when
graphviz is absent.
"""

from __future__ import annotations

import numpy as _np


def block_summary(block, *inputs):
    """Per-layer summary of a Gluon block (reference: Block.summary)."""
    summary = []

    def walk(blk, name, depth):
        n_params = 0
        for p in blk._reg_params.values():
            if p.shape is not None and all(s > 0 for s in p.shape):
                n_params += int(_np.prod(p.shape))
        summary.append((name or blk.name, type(blk).__name__, n_params,
                        depth))
        for child_name, child in blk._children.items():
            walk(child, f"{name}.{child_name}" if name else child_name,
                 depth + 1)

    walk(block, "", 0)
    total = 0
    lines = [f"{'Layer':<44}{'Type':<24}{'Params':>12}", "-" * 80]
    for name, tname, n, depth in summary:
        total += n
        lines.append(f"{'  ' * depth + (name or tname):<44}{tname:<24}"
                     f"{n:>12}")
    lines.append("-" * 80)
    lines.append(f"{'Total params':<68}{total:>12}")
    out = "\n".join(lines)
    print(out)
    return out


def print_summary(symbol_or_block, shape=None, line_length=120,
                  positions=(.44, .64, .74, 1.)):
    """mx.viz.print_summary: a block's parameter table, or a Symbol's
    nodes (op and name)."""
    from .gluon.block import Block

    if isinstance(symbol_or_block, Block):
        return block_summary(symbol_or_block)
    lines = [f"{'Op':<40}{'Name':<40}", "-" * 80]
    for node in symbol_or_block.list_nodes():
        lines.append(f"{node.get('op', 'null'):<40}"
                     f"{node.get('name', ''):<40}")
    out = "\n".join(lines)
    print(out)
    return out


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """mx.viz.plot_network: a graphviz ``Digraph`` of the Symbol, or the
    text summary when graphviz is not installed."""
    try:
        import graphviz
    except ImportError:
        return print_summary(symbol)
    dot = graphviz.Digraph(name=title)
    for node in symbol.list_nodes():
        op = node.get("op", "null")
        name = node.get("name", "")
        if hide_weights and op == "null" and (
                name.endswith("weight") or name.endswith("bias")):
            continue
        dot.node(name, f"{op}\n{name}")
        for src in node.get("inputs", []):
            dot.edge(str(src), name)
    return dot
