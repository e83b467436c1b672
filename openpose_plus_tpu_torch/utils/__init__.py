"""Host-side helpers: skeleton drawing and debug renders (`vis`), scope
timing and device traces (`tracer`)."""
