"""The SO3 training path of the port: the QAT trainer and the paper's
experiment pipeline."""
