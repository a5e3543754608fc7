import logging

logger = logging.getLogger("gradflow_torch")
