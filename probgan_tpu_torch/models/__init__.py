"""Model zoo: the progressive image generator."""
