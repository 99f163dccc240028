"""The system under test, one module a configuration's ``driver``."""
