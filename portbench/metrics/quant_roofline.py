"""``quant_roofline``: kernels B1 (``quantize_rows``) and B2
(``dequant_add``) against their least time.  The mean least time of the
window's launches (``counts.quant_bound`` of each launch's shape, as the
program's launch hook reports it) over the mean device time of their
kernels in the trace; the means keep the share true where the profiler
drops a record."""

import re

from portbench import counts

KERNEL = re.compile(r"\b(quantize|dequant_add)_(vec|scalar)_kernel")


def read(ctx):
    tr = ctx.trace
    if not tr or not ctx.launches:
        return None
    least = [counts.least_seconds(*counts.quant_bound(k, c, w))
             for k, c, w in ctx.launches]
    hits = [(n, s) for name, (n, s) in tr["kernels"].items()
            if KERNEL.search(name)]
    count, seconds = sum(n for n, _ in hits), sum(s for _, s in hits)
    if not count or seconds <= 0:
        return None
    return 100.0 * (sum(least) / len(least)) / (seconds / count)
