"""Request loops: a mix's ``"loop": "<name>"`` is run by ``<name>.py``,
whose ``run(system, inp, specs, seconds, rec, mix)`` serves the window's
requests and returns (done, failed, t0, t_end): done [(spec, answer)], the
count of requests the system failed, and the window's start and its last
completion in ns.  A loop of another kind is added as a file."""
