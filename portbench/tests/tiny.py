"""Cells at a size the CPU runs in seconds, for the harness's tests:
every width cut to a hundred or so, four layers, the cell's own
drivers.  At this size the float8 control still reads well above the
cells' limits (0.53-0.70 against 0.3 on four seeds for a served
model), where two layers of width 64 read as low as 0.22."""

import time

from portbench.lib import cells

TINY = dict(hidden_size=128, num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=256, num_hidden_layers=4, vocab_size=1024,
            max_position_embeddings=512)
SHORT = {"dist": "loguniform", "lo": 8, "hi": 48}
FEW = {"dist": "uniform", "lo": 8, "hi": 24}


def cell(name: str, seed: int = 2 ** 31 + 11, seconds: float = 1.5,
         dtype: str = "float32", **kw) -> cells.Cell:
    c = cells.cell(cells.benchmark(), name, seed=seed, seconds=seconds,
                   device="cpu", t_start=time.monotonic(), **kw)
    c.cfg = dict(c.cfg, **TINY, torch_dtype=dtype)
    if c.cfg["kind"] == "train":
        c.mix = dict(c.mix, batch=4, seq_len=32)
    else:
        c.cfg["engine"] = dict(c.cfg["engine"], max_batch=8, prefill_chunk=32)
        c.mix = dict(c.mix, block=8, warmup_s=0.5, prompt_len=SHORT,
                     output_len=FEW)
        if c.mix["kind"] == "closed_loop":
            c.mix["clients"] = 8
        else:
            c.mix.update(rate_per_s=10.0, shared_prefix=32)
    return c
