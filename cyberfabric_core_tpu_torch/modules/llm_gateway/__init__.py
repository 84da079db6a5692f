"""The llm-gateway module of the port: its chat and completion handlers
(:mod:`.module`), the local worker on the port's engine (:mod:`.worker`) and
the wire schemas (:mod:`.schemas`)."""
