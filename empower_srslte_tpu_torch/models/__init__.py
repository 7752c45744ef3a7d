"""Channel processors and the UE/eNB downlink chains."""
