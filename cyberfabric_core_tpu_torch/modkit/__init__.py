"""The host substrate the port serves with: its own copy of the parts of
``modkit`` that the chat path uses (problems and their catalog, SSE framing,
the security context) and observes it with (the metrics registry, tracing,
the flight recorder, failpoints and the doctor)."""
