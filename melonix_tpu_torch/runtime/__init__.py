"""Host runtime of the port: the native C++ grain chain and render plan."""
