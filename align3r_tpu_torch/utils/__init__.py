"""Small file formats (PNG, Sintel) without an imaging library."""
