"""Host-side helpers: skeleton drawing and debug renders (`vis`), the
port's spans and counters and device timing (`tracer`)."""
