"""Chaos runner: SIGKILL the port's flight recorder mid-dump-write.

Spawned by `test_torch_observability.py` with
`ADANET_FAULTS="flightrec.dump:kill:after=1"`: the first dump's
stage->rename seam is a clean hit; the second dump is SIGKILLed between
staging and rename. The parent asserts that the prior dump at the final
path stays intact and parseable, and that no partial dump is readable
(the abandoned stage file is a `.stage-*` stray, reclaimed by the next
dump). The port's copy of tests/flightrec_chaos_runner.py.
"""

import sys

from adanet_tpu_torch.observability import FlightRecorder, install


def main():
    directory = sys.argv[1]
    recorder = install(FlightRecorder(directory))
    tracer = recorder.tracer
    tracer.enable()
    with tracer.span("chaos.phase", correlation={"search_id": "chaos"}):
        tracer.instant("first.marker")
    path = recorder.dump("first")
    assert path, "first dump failed"
    print("FIRST DUMP OK", flush=True)
    tracer.instant("second.marker")
    # The armed kill fires between stage and rename.
    recorder.dump("second")
    print("UNEXPECTED SECOND DUMP COMPLETION", flush=True)


if __name__ == "__main__":
    main()
