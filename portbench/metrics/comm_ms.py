"""``comm_ms``: the comm step's time on the card a round, from the CUDA
events the benchmark records around the program's ``comm_round`` call:
from the card reaching the call's first work to its last, gaps the host
leaves in between included."""


def read(ctx):
    return sum(ctx.comm_ms) / len(ctx.comm_ms) if ctx.comm_ms else None
