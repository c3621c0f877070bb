"""
The model summary printed at train start (counterpart of
``fmdm_tpu/utils/summary.py``): a tree of parameter counts built from
the state dict — module path, leaf tensor shapes, per-subtree
totals — unless ``training.show_model_summary`` is false. Depth is
``training.summary_depth`` (default 3; <= 0 means full depth). The JAX
package's trees carry torch's names and layouts, so the text is the same
for the same model.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, List

import torch


def _fmt(count: int) -> str:
    if count >= 1e9:
        return f"{count / 1e9:.2f}B"
    if count >= 1e6:
        return f"{count / 1e6:.2f}M"
    if count >= 1e3:
        return f"{count / 1e3:.2f}K"
    return str(count)


def _count(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    return math.prod(tree)


def _leaf_shapes(tree) -> str:
    """Compact 'weight (128,2,3,3), bias (128,)' description of a module's
    own leaf tensors (non-dict children)."""
    return ", ".join(f"{key} {tuple(value)}" for key, value in tree.items()
                     if not isinstance(value, dict))


def _tree_lines(tree: Dict, prefix: str, depth: int, max_depth: int, lines: List[str]) -> None:
    keys = sorted(tree.keys(), key=lambda k: (not isinstance(tree[k], dict), k))
    dict_keys = [k for k in keys if isinstance(tree[k], dict)]
    for idx, key in enumerate(dict_keys):
        sub = tree[key]
        last = idx == len(dict_keys) - 1
        branch = "└─" if last else "├─"
        label = f"{prefix}{branch} {key}"
        total = _count(sub)
        if max_depth > 0 and depth >= max_depth:
            lines.append(f"{label:<52} {_fmt(total):>10}")
            continue
        shapes = _leaf_shapes(sub)
        detail = f"  [{shapes}]" if shapes and not any(
            isinstance(v, dict) for v in sub.values()) else ""
        lines.append(f"{label:<52} {_fmt(total):>10}{detail}")
        _tree_lines(sub, prefix + ("   " if last else "│  "), depth + 1, max_depth, lines)


def _shape_tree(model: torch.nn.Module) -> Dict:
    """``{module: {...: shape}}`` nested by the dotted state-dict names (the
    parameters, and a VQ codebook's buffers, which the JAX tree holds)."""
    tree: Dict = {}
    for name, param in model.state_dict().items():
        *parents, leaf = name.split(".")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = tuple(param.shape)
    return tree


def summarize_model(model: torch.nn.Module, model_cfg: Dict, training_cfg: Dict,
                    name: str = "model") -> int:
    """Log and print the summary; returns the parameter count."""
    tree = _shape_tree(model)
    total = _count(tree)
    if not training_cfg.get("show_model_summary", True):
        return total
    max_depth = int(training_cfg.get("summary_depth", 3))
    lines = [f"{name} parameter summary (depth {'full' if max_depth <= 0 else max_depth}):",
             f"{name:<55} {_fmt(total):>10}"]
    _tree_lines(tree, "", 1, max_depth, lines)
    lines.append(f"{'TOTAL':<55} {_fmt(total):>10} ({total:,})")
    text = "\n".join(lines)
    logging.info("%s", text)
    print(text, flush=True)
    return total
