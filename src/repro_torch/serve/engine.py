"""Serving engine: prefill and decode step builders.

Port of ``repro.serve.engine``. The model holds its weights, so a step
takes ``(cache, batch)`` or ``(cache, tokens)`` where the reference's takes
``params`` first; the builders serve every family alike. A prefill's batch
carries ``tokens (B, S)``, and ``src_frames (B, S_src, D)`` for the audio
family or ``prefix_embeds (B, P, D)`` for vlm. Steps run under
``torch.inference_mode`` and write the cache or recurrent state in place
(see ``models.attention.KVCache``).

The KV-cache sharding policy (``cache_axes_for_mesh``, ``serve_shardings``),
the reference's:
  - batch over ("pod", "data");
  - kv_heads over "model" when the head count divides the axis;
  - otherwise the cache *sequence* dim is sharded over "model" (the
    "seq_sharded" logical axis), which balances the memory.
"""
from __future__ import annotations

from ..distributed.sharding import SERVE_RULES, mesh_axes, plan_tree

__all__ = ["cache_axes_for_mesh", "serve_shardings", "build_prefill",
           "build_decode"]


def cache_axes_for_mesh(model, mesh):
    """Model cache axes, with the kv_heads -> seq fallback applied
    mesh-wide."""
    axes = model.cache_axes()
    msize = mesh_axes(mesh).get("model", 1)
    if msize > 1 and model.cfg.n_kv_heads % msize != 0:
        axes = type(axes)(*[tuple("seq_sharded" if a == "seq" else a
                                  for a in t) for t in axes])
    return axes


def serve_shardings(mesh, model, params_abstract, axes_tree, cache_abstract):
    """(param plans, cache plans) for serving on ``mesh``: the parameters
    by state-dict name (``params_abstract`` and ``axes_tree`` are dicts of
    tensors and of logical axes), the cache as its own NamedTuple."""
    p_sh = plan_tree(mesh, params_abstract, axes_tree, SERVE_RULES)
    c_sh = plan_tree(mesh, cache_abstract, cache_axes_for_mesh(model, mesh),
                     SERVE_RULES)
    return p_sh, c_sh


def build_prefill(model):
    def prefill_step(cache, batch):
        return model.prefill(cache, batch)

    return prefill_step


def build_decode(model):
    def decode_step(cache, tokens):
        return model.decode_step(cache, tokens)

    return decode_step
