"""Module binding, generation serving and the request queue."""
