"""The candidates the sampler proposed (the program's ``sample.candidates``
counter, counted from shapes the host holds) over the triplets the
window's calls asked for: where the sample is a permutation prefix of its
domain, the capacities' slots the walk covers over the budget (1.0 at
exact capacities, below 2 at powers of two); where it overdraws, the
plan's proposals over the budget."""

from portbench import details, stages

NAME = "sample.candidates"


def read(summary, ctx):
    return details.count_per_triplet(stages.program_log(), ctx, NAME)
