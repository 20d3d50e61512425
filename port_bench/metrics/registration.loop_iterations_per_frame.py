"""The align loop's iterations a fleet frame, the mean over the window: the
loop runs to its slowest stream, so a frame's is the largest of its streams'
``align_iterations``."""


def read(run):
    its = run.loop_iterations
    return sum(its) / len(its) if its else None
