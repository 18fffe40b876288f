"""The mesh's imbalance: the largest rank's ``solve`` wall over the mean
of the ranks', a cube, averaged over the window's cubes. Only a mesh of
more than one rank has anything to read."""


def read(ctx):
    per_rank = ctx["rank_solve_s"]
    if len(per_rank) < 2:
        return None
    ratios = [max(walls) / (sum(walls) / len(walls))
              for walls in zip(*per_rank)]
    return sum(ratios) / len(ratios), "ratio"
