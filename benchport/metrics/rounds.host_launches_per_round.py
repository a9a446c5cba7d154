"""Host launches a round: the CUDA graphs and kernels the host launched
(``cudaGraphLaunch``, ``cudaLaunchKernel`` and the driver's forms) in the
traced window, over the rounds run in it. One where a round replays one
captured graph and nothing else is launched."""

from benchport import tracing


def read(ctx):
    if ctx.trace is None or ctx.unit != "round" or not ctx.trace.units:
        return None
    return tracing.launches(ctx.trace) / ctx.trace.units
