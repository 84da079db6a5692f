"""The modules of the port's serving host: the model registry, the
llm-gateway handlers and its worker, and their SDK contracts."""
