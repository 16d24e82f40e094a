"""ADAG: ``center += mean_i (worker_i − center)``."""


def fold(delta):
    return delta.mean(dim=0)
