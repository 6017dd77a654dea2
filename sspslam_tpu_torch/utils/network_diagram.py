"""Model-structure introspection: render a built Model (or a declarative
Network) as a Graphviz .dot document (port of
:mod:`sspslam_tpu.utils.network_diagram`).

It reads the port's built :class:`nef.builder.Model`: ensembles are
ellipses, nodes are boxes, batched ensemble arrays are double octagons
annotated with (k x n x dim), learned connections are red, filtered
connections are labelled with their tau.  A ``Network`` is built first,
on ``device`` (default ``cuda``: the builder solves large decoders
there).  The .dot source is written directly (no graphviz python
dependency); if the ``dot`` binary exists, a PNG/SVG is rendered too.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional

import torch

__all__ = ["network_diagram", "process_and_save_diagram"]


def _esc(s):
    return str(s).replace('"', "'")


def network_diagram(model_or_network, dt: float = 0.001, *,
                    device="cuda") -> str:
    """Return Graphviz .dot source describing the compiled structure; a
    ``Network`` is built on ``device`` first."""
    from ..nef.builder import build
    from ..nef.graph import Network

    if isinstance(model_or_network, Network):
        if (torch.device(device).type == "cuda"
                and not torch.cuda.is_available()):
            raise RuntimeError("network_diagram: device='cuda' but no CUDA "
                               "device is available")
        model = build(model_or_network, dt=dt, device=device)
    else:
        model = model_or_network

    lines = ["digraph model {", "  rankdir=LR;",
             '  node [fontsize=10, fontname="Helvetica"];']

    def node_id(obj):
        return f"n{id(obj)}"

    # graph nodes
    for info in model.node_info.values():
        node = info["node"]
        label = _esc(node.label or "node")
        shape = {"tabulated": "invhouse", "const": "cds",
                 "jnp_func": "component"}.get(info["kind"], "box")
        lines.append(f'  {node_id(node)} [label="{label}", shape={shape}];')
    for be in model.ensembles:
        label = _esc(getattr(be.obj, "label", None) or "ens")
        if be.batched:
            lines.append(
                f'  {node_id(be)} [label="{label}\\n{be.k}x{be.n}x{be.dim}",'
                f' shape=doubleoctagon, color="#3465a4"];')
        else:
            lines.append(
                f'  {node_id(be)} [label="{label}\\n{be.n}x{be.dim}",'
                f' shape=ellipse, color="#4e9a06"];')

    def endpoint(kind, obj):
        if kind in ("node",):
            return node_id(obj)
        return node_id(obj)

    for bc in model.connections:
        src = endpoint(bc.pre_kind, bc.pre)
        if bc.post_kind in ("pes", "voja"):
            # rule-input edges point at the learned connection's pre ensemble
            tgt_bc = None
            for cand in model.connections:
                if cand.learned_slot and bc.index in cand.rule_target_conns:
                    tgt_bc = cand
                    break
            if tgt_bc is None:
                continue
            dst = endpoint(tgt_bc.pre_kind, tgt_bc.pre)
            lines.append(
                f'  {src} -> {dst} [style=dashed, color="#cc0000", '
                f'label="{bc.post_kind}"];')
            continue
        dst = endpoint(bc.post_kind, bc.post)
        attrs = []
        if bc.learned_slot:
            attrs.append('color="#cc0000"')
            attrs.append('label="learned"')
        elif bc.synapse is not None:
            tau = bc.synapse if isinstance(bc.synapse, (int, float)) else \
                getattr(bc.synapse, "tau", "?")
            attrs.append(f'label="t={tau}"')
        if bc.post_kind == "neurons":
            attrs.append("style=dotted")
        lines.append(f"  {src} -> {dst} [{', '.join(attrs)}];")

    lines.append("}")
    return "\n".join(lines)


def process_and_save_diagram(model_or_network, filename: str,
                             dt: float = 0.001,
                             render: Optional[str] = "png", *,
                             device="cuda") -> str:
    """Write the .dot file (and a rendered image when the dot binary is
    available). Returns the .dot path."""
    dot = network_diagram(model_or_network, dt=dt, device=device)
    base, ext = os.path.splitext(filename)
    dot_path = base + ".dot"
    with open(dot_path, "w") as f:
        f.write(dot)
    if render and shutil.which("dot"):
        try:
            subprocess.run(["dot", f"-T{render}", dot_path, "-o",
                            base + f".{render}"], check=True,
                           capture_output=True)
        except subprocess.CalledProcessError:
            pass
    return dot_path
