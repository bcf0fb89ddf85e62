"""Composer-cluster labels for the Maestro dataset (legacy path).

A copy of ``rule_guided_music_tpu/data/composer_clusters.py`` (csv only;
reference guided_diffusion/embed_datasets.py:12-76): 9 composer
clusters grouped by era/style, used by the older 9-class-conditional
experiments. Provided for capability parity with the reference's
composer-conditional configs.
"""

from __future__ import annotations

import csv
from typing import Dict, List, Optional, Tuple

CLUSTERS: Dict[int, List[str]] = {
    0: ["Johann Sebastian Bach", "George Frideric Handel",
        "Domenico Scarlatti", "Jean-Philippe Rameau"],
    1: ["Wolfgang Amadeus Mozart", "Joseph Haydn", "Muzio Clementi"],
    2: ["Ludwig van Beethoven", "Franz Schubert", "Carl Maria von Weber"],
    3: ["Frédéric Chopin", "Robert Schumann", "Felix Mendelssohn",
        "Johannes Brahms"],
    4: ["Franz Liszt", "Niccolò Paganini", "Mily Balakirev"],
    5: ["Claude Debussy", "Maurice Ravel", "Erik Satie",
        "Gabriel Fauré"],
    6: ["Sergei Rachmaninoff", "Alexander Scriabin", "Nikolai Medtner",
        "Sergei Prokofiev"],
    7: ["Pyotr Ilyich Tchaikovsky", "Modest Mussorgsky",
        "Nikolai Rimsky-Korsakov", "Antonín Dvořák", "Edvard Grieg",
        "Isaac Albéniz", "Enrique Granados"],
    8: ["Alban Berg", "Arnold Schoenberg", "Béla Bartók",
        "György Ligeti", "Charles Ives", "Leoš Janáček",
        "Olivier Messiaen", "Dmitri Shostakovich", "Igor Stravinsky"],
}

COMPOSER_TO_CLUSTER: Dict[str, int] = {
    composer: cluster
    for cluster, composers in CLUSTERS.items()
    for composer in composers
}

NUM_COMPOSER_CLUSTERS = len(CLUSTERS)


def cluster_for(composer: str) -> Optional[int]:
    """Cluster id for a canonical composer name (None if unmapped)."""
    return COMPOSER_TO_CLUSTER.get(composer)


def label_maestro_csv(
    maestro_csv: str, out_csv: str,
    filename_col: str = "midi_filename",
    composer_col: str = "canonical_composer",
) -> Tuple[int, int]:
    """Read a maestro metadata CSV and emit a manifest with cluster labels.

    Rows whose composer isn't in the cluster map are dropped (the reference
    keeps only mapped composers). Returns (kept, dropped).
    """
    kept = dropped = 0
    with open(maestro_csv, newline="") as f_in, \
            open(out_csv, "w", newline="") as f_out:
        reader = csv.DictReader(f_in)
        writer = csv.writer(f_out)
        writer.writerow(["midi_filename", "classes"])
        for row in reader:
            cluster = cluster_for(row[composer_col])
            if cluster is None:
                dropped += 1
                continue
            writer.writerow([row[filename_col], cluster])
            kept += 1
    return kept, dropped
