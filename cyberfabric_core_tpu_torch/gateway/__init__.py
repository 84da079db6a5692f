"""The port's HTTP host: routes (:mod:`.router`), the middleware layers
(:mod:`.middleware`), JSON Schema request validation (:mod:`.validation`)
and the server on ``asyncio`` streams (:mod:`.module`)."""
