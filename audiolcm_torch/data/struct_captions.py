"""Structured-caption parsing for order-conditioned models
(`audiolcm_tpu/data/struct_captions.py`).

Reference `ldm/modules/encoders/modules.py:342-475` (FrozenCLAPOrderEmbedder2/3):
a struct caption like '<man speaking& order 1 start>@<idle engine& all>' is
split on '@' into `<obj& order>` chunks; the objects are joined with ' | '
(a '|' after every object) for tokenization, and the orders map to integer
labels with either the full (order x time) table (10 orders x start/mid/end
+ all + unknown) or the time-only table (all/start/mid/end).
"""

from __future__ import annotations

from typing import Dict, List, Tuple


def build_order_dict(time_only: bool = False) -> Dict[str, int]:
    if time_only:
        return {t: i for i, t in enumerate(["all", "start", "mid", "end"])}
    stamps = ["start", "mid", "end"]
    table = {f"order {i} {ts}": i * len(stamps) + j for i in range(10)
             for j, ts in enumerate(stamps)}
    table["all"] = 10 * len(stamps)
    table["unknown"] = 10 * len(stamps) + 1
    return table


def parse_struct_caption(raw: str, order_to_label: Dict[str, int]) -> Tuple[str, List[int]]:
    """'<obj& order>@<obj2& order2>' -> ('obj | obj2 |', [label, label2])."""
    objs: List[str] = []
    orders: List[int] = []
    for chunk in raw.split("@"):
        chunk = chunk.strip()
        if chunk.startswith("<") and chunk.endswith(">"):
            chunk = chunk[1:-1]
        obj, order = chunk.split("&")
        objs.append(obj.strip())
        orders.append(order_to_label.get(order.strip(), order_to_label.get("unknown", 0)))
    return " | ".join(objs) + " |", orders


def parse_struct_captions(raws: List[str], time_only: bool = False
                          ) -> Tuple[List[str], List[List[int]]]:
    table = build_order_dict(time_only)
    parsed = [parse_struct_caption(raw, table) for raw in raws]
    return [p[0] for p in parsed], [p[1] for p in parsed]
