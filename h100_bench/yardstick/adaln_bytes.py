"""Device-memory bytes of the DiT block's adaLN backward launches, from the
shapes alone: each operand row read once and each gradient written once,
whatever a kernel reads again (its partial sums included in nothing).

A launch over ``E = B·N·D`` elements reads ``x'`` (float32) and ``∂h`` (in
h's dtype), and for the gated pass ``y`` and, where ``x'`` is used
downstream, ``∂x'`` (float32); it writes ``∂x`` (float32) and for the gated
pass ``∂y``.  Of the ``[B, D]`` modulations it reads ``scale`` (and
``gate``) and writes ``∂shift`` and ``∂scale`` (and ``∂gate``).
"""

from __future__ import annotations


def adaln_backward_bytes(batch: int, tokens: int, width: int, gated: bool, dxs: bool,
                         h_itemsize: int = 2, y_itemsize: int = 2, mod_itemsize: int = 2) -> int:
    """The bytes one backward launch moves at least."""
    e, m = batch * tokens * width, batch * width
    rows = e * (4 + h_itemsize + 4)
    mods = m * mod_itemsize * 3
    if gated:
        rows += e * 2 * y_itemsize + (e * 4 if dxs else 0)
        mods += m * mod_itemsize * 2
    return rows + mods


def dit_step_backward_bytes(depth: int, batch: int, tokens: int, width: int) -> int:
    """The bytes of one DiT train step's adaLN backward launches, bf16 ``h``,
    ``y`` and modulations: the first block's ungated pass, the ``2·depth −
    1`` seams whose ``x'`` flows on, and the last block's end into the final
    norm, whose ``x'`` is used nowhere else."""
    one = lambda gated, dxs: adaln_backward_bytes(batch, tokens, width, gated, dxs)
    return one(False, False) + (2 * depth - 1) * one(True, True) + one(True, False)
