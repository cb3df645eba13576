"""Traffic mixes (``<name>.json``) and the generator that reads them."""
