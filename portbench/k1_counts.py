"""K1's float32 operations counted from the program's own counters, for
cells whose calls change d and p from one call to the next.

Each K1 epoch the program's trainer adds to the open call's record (from
the training rows the host holds, with no sync):

- ``k1.run_steps``: the executed steps, one batch of one run each;
- ``k1.adam_elements``: the dense Adam's element updates, (n + m) d a step.

``roofline.k1_flops`` counts ``bs (9 d + 15) + 16 (n + m) d + 6`` a step;
summed over steps of any d, with n, m and bs from the configuration:

    run_steps (15 bs + 6) + 9 bs adam_elements / (n + m)
        + 16 adam_elements

A program without the counters, the parent of the change that added them,
reads None.
"""

from __future__ import annotations

from typing import List, Optional

RUN_STEPS = "k1.run_steps"
ADAM_ELEMENTS = "k1.adam_elements"


def flops(records: Optional[List[dict]], study: dict) -> Optional[float]:
    """K1's operations over the call records ``records``; None where none
    holds the counters or they count no step."""
    steps = elements = 0
    seen = False
    for r in records or []:
        counters = r.get("counters") or {}
        if RUN_STEPS in counters and ADAM_ELEMENTS in counters:
            seen = True
            steps += counters[RUN_STEPS]
            elements += counters[ADAM_ELEMENTS]
    if not seen or not steps:
        return None
    n, m, bs = study["n"], study["m"], study["batch_size"]
    return float(steps * (15 * bs + 6) + 9 * bs * elements / (n + m)
                 + 16 * elements)
