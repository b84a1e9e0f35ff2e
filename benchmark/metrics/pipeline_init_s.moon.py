"""Seconds of AudioLCMPipeline.__init__ in the caption-LLM cell's set-up
(the program's `init` span: the weights assigned to the modules, the
modules cast to the serving dtype, and the kernels' weights packed, K7's
stacked experts among them)."""

from benchmark.harness import spans

LAYER = "whole generate (pipeline.AudioLCMPipeline)"
UNIT, MOVES, SOURCE = "s", "setup_s", "program_span"


def read(r):
    return spans.init_s(r)
