"""Applications (reference apps/): the gnb executable and helpers."""
