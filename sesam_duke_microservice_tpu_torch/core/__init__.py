from .records import Record, Property, Lookup, SchemaError
from .bayes import compute_bayes, combine_probabilities, probability_logit

__all__ = [
    "Record",
    "Property",
    "Lookup",
    "SchemaError",
    "compute_bayes",
    "combine_probabilities",
    "probability_logit",
]
