"""The system under test: a configuration file as the port's
``ModelConfig``, one module a ``model_type``."""
