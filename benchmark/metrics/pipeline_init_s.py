"""Seconds of AudioLCMPipeline.__init__ in set-up (the program's `init`
span: the weights loaded into the modules and the modules moved and cast
to the serving dtype)."""

from benchmark.harness import spans

LAYER = "whole generate (pipeline.AudioLCMPipeline)"
UNIT, MOVES, SOURCE = "s", "setup_s", "program_span"


def read(r):
    return spans.init_s(r)
