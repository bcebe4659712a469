"""Serving engine: prefill and decode step builders.

Port of ``repro.serve.engine``. The model holds its weights, so a step
takes ``(cache, batch)`` or ``(cache, tokens)`` where the reference's takes
``params`` first; the builders serve every family alike. A prefill's batch
carries ``tokens (B, S)``, and ``src_frames (B, S_src, D)`` for the audio
family or ``prefix_embeds (B, P, D)`` for vlm. Steps run under
``torch.inference_mode`` and write the cache or recurrent state in place
(see ``models.attention.KVCache``).
``cache_axes_for_mesh`` and ``serve_shardings`` wait for the
``distributed/`` item (ROADMAP queue 1, item 11).
"""
from __future__ import annotations

__all__ = ["build_prefill", "build_decode"]


def build_prefill(model):
    def prefill_step(cache, batch):
        return model.prefill(cache, batch)

    return prefill_step


def build_decode(model):
    def decode_step(cache, tokens):
        return model.decode_step(cache, tokens)

    return decode_step
