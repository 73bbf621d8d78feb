"""Integer math, observability, the flight recorder and the debug modes
(the sanitizer and the race checker)."""
