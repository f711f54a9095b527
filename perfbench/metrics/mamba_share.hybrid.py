"""The Mamba layers' share of prefill: in the traced waves' ``serve.prefill``
spans, the device time of the ``mamba`` spans inside them (each layer's norm,
projections, conv, scan and gated norm; not the shared blocks) over the
prefill spans' device time, in percent. Prefill runs with the host ahead of
the card, so the device times are the spans' timing events on the stream.
Read from the program's spans; none recorded, or no device times, nothing
to read."""

from perfbench.yardstick import spans


def read(trace):
    part = whole = 0.0
    for w in spans.waves(trace):
        for prefill in w.get("serve.prefill", []):
            inner = spans.within(prefill, w, ("mamba",))
            if not inner or prefill.device_s is None or any(s.device_s is None for s in inner):
                return None
            part += sum(s.device_s for s in inner)
            whole += prefill.device_s
    return 100.0 * part / whole if whole > 0 else None
